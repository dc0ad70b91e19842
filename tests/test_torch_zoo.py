"""Port vs JAX package for the neural-field decoder zoo: every registry name
(``confild_tpu/models/cnf.py`` + ``cnf_zoo.py``), the plain SIREN, feature
mapping, MFN and both MLPs, ``io/convert.py::nf_state_dict_from_jax``, and
the CNF trainer on the zoo's auto-decoders against the JAX trainer.

The same seeded numpy inputs go through both packages, the JAX parameters
carried into the port by ``nf_state_dict_from_jax``.  Tolerances: forwards
and parameter gradients are float32 evaluations of the same layers in
another summation order: rtol 1e-5, atol 1e-6, the atol of a gradient
leaf scaled by its largest magnitude when that passes 1 (each sine layer
multiplies a gradient by w0 = 30, so the leaves reach magnitudes of 10, and
a float32 sum taken in another order moves them by a few 1e-6); the trainer's trajectories are held at the port's
trainer tolerance (``tests/test_torch_train.py``: rtol 5e-3, atol 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from confild_tpu.io.checkpoint import save_pytree
from confild_tpu.models import cnf as jcnf
from confild_tpu.models import cnf_zoo  # noqa: F401 - registers the zoo
from confild_tpu.models import mlp as jmlp
from confild_tpu.train.cnf_trainer import CNFTrainer as JTrainer
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.cli import eval_cnf, train_cnf
from confild_tpu_torch.inference import CNF_inference
from confild_tpu_torch.io import convert
from confild_tpu_torch.models import cnf as tcnf
from confild_tpu_torch.models import mlp as tmlp
from confild_tpu_torch.train.cnf_trainer import CNFTrainer as TTrainer
from test_cnf_trainer import make_case
from torch_parity_utils import limit_torch_threads, t

TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=5e-3, atol=1e-5)

COMMON = dict(in_coord_features=2, in_latent_features=8, out_features=3,
              num_hidden_layers=2, hidden_features=16)
AE_COMMON = dict(hyper_in_features=5, hyper_latent_features=8, hyper_num_hidden_layers=1,
                 hyper_hidden_features=16, nf_in_features=2, out_features=3,
                 nf_num_hidden_layers=2, nf_hidden_features=16)
# registry name -> (kwargs, the call's inputs: coords kind and second argument)
CASES = {
    "SIRENAutodecoder_film": (COMMON, "grid", "latents"),
    "SIRENAutodecoder_film_extra_in": (dict(COMMON, in_coord_features=3), "pair", "latents"),
    "SIRENAutodecoder_film_single": (
        dict(in_coord_features=2, out_features=3, num_hidden_layers=2, hidden_features=16),
        "grid", "all_latents"),
    "SIREN_rez_Autodecoder_film": (dict(COMMON, num_hidden_layers_rez=2), "grid", "latents"),
    "SIRENAutodecoder_tw_film": (dict(COMMON, w0_init=25.0), "grid", "latents"),
    "FNAutodecoder_film": (COMMON, "grid", "latents"),
    "GNAutodecoder_film": (dict(COMMON, input_scale=16.0), "grid", "latents"),
    "SIRENAutodecoder_fp": (COMMON, "grid", "latents"),
    "SIRENAutodecoder_mdf_film": (COMMON, "grid", "latents"),
    "SIRENAutodecoder_mdf_film_extra_in": (dict(COMMON, in_coord_features=3), "pair",
                                           "latents"),
    "SIRENAutoencoder_film": (AE_COMMON, "grid", "priors"),
    "SIRENAutoencoder_film_extra_in": (dict(AE_COMMON, nf_in_features=3), "pair", "priors"),
    "SIRENAutoencoder_fp": (AE_COMMON, "grid", "priors"),
}
# the auto-decoders the CNF trainer takes (the JAX trainer trains each)
TRAINED = ("SIREN_rez_Autodecoder_film", "FNAutodecoder_film", "SIRENAutodecoder_tw_film",
           "SIRENAutodecoder_fp", "SIRENAutodecoder_mdf_film")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(name, seed=0):
    kwargs = CASES[name][0]
    jm = jcnf.create_nf(name, **kwargs)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    port = tcnf.create_nf(name, **kwargs)
    port.load_state_dict(convert.nf_state_dict_from_jax(name, params))   # strict: same keys
    return jm, params, port


def _inputs(name, rng):
    """numpy inputs ``(coords, second)``; a pair's coords are ``(spatial,
    extra)`` with the spatial points per sample (the zoo's ``_extra_in``
    does not broadcast them)."""
    _, kind, second = CASES[name]
    if kind == "pair":
        coords = (rng.uniform(size=(4, 30, 2)).astype(np.float32),
                  rng.uniform(size=(4, 1, 1)).astype(np.float32))
    else:
        coords = rng.uniform(size=(4, 30, 2)).astype(np.float32)
    if second == "latents":
        z = (0.1 * rng.standard_normal((4, 1, 8))).astype(np.float32)
    elif second == "priors":
        z = rng.standard_normal((4, 1, 5)).astype(np.float32)
    else:   # one additive latent a modulated layer
        z = (0.1 * rng.standard_normal((3, 4, 1, 16))).astype(np.float32)
    return coords, z


def _torch_in(x):
    return tuple(t(a) for a in x) if isinstance(x, tuple) else t(x)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def test_registry_lists_every_jax_name():
    assert sorted(tcnf.NF_REGISTRY) == sorted(jcnf.NF_REGISTRY)
    assert sorted(CASES) == sorted(jcnf.NF_REGISTRY)
    with pytest.raises(KeyError, match="SIREN_rez_Autodecoder_film"):
        tcnf.create_nf("nope")


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_param_grads_match_jax(name):
    """The forward (every returned array) and the gradient of ``sum(out *
    g)`` with respect to every parameter, against ``jax.grad``."""
    jm, params, port = _pair(name)
    rng = np.random.default_rng(1)
    coords, z = _inputs(name, rng)
    jparams = jax.tree.map(jnp.asarray, params)
    jouts = _outs(jax.jit(lambda p: jm(p, coords, z))(jparams))
    gs = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in jouts]

    def loss(p):
        return sum(jnp.sum(o * g) for o, g in zip(_outs(jm(p, coords, z)), gs))
    jgrads = convert.nf_state_dict_from_jax(name, jax.jit(jax.grad(loss))(jparams))

    touts = _outs(port(_torch_in(coords), t(z)))
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    sum((o * t(g)).sum() for o, g in zip(touts, gs)).backward()
    grads = dict(port.named_parameters())
    assert sorted(grads) == sorted(jgrads)
    for k, p in grads.items():
        _close_grad(p.grad, jgrads[k], k)


def _close_grad(got, want, name):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, err_msg=name, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))


def test_film_single_without_latents_matches_jax():
    jm, params, port = _pair("SIRENAutodecoder_film_single")
    coords = np.random.default_rng(2).uniform(size=(4, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(port(t(coords))), np.asarray(jm.apply(params, coords)),
                               **TOL)


def _leaf_stats(x):
    x = np.asarray(x, np.float64).ravel()
    return x.mean(), x.std(), np.abs(x).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_draws_the_jax_distributions(name):
    """``reset_parameters(generator)`` against the JAX ``init_params``: the
    same leaves; constant leaves equal; every leaf of 256 or more values
    with the JAX leaf's mean, spread and largest magnitude (the bounds)
    within sampling error."""
    kwargs = dict(CASES[name][0])
    if "hidden_features" in kwargs:
        kwargs["hidden_features"] = 64          # enough values a leaf
    jm = jcnf.create_nf(name, **kwargs)
    want = convert.nf_state_dict_from_jax(
        name, jax.tree.map(np.asarray, jm.init_params(jax.random.key(3))))
    port = tcnf.create_nf(name, **kwargs)
    port.reset_parameters(torch.Generator().manual_seed(3))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w, g = w.numpy(), got[k].numpy()
        assert g.shape == w.shape, k
        if np.all(w == w.ravel()[0]):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.size >= 256:
            (wm, ws, wx), (gm, gs, gx) = _leaf_stats(w), _leaf_stats(g)
            assert abs(gm - wm) < 0.25 * ws + 1e-12, k
            assert 0.8 < gs / ws < 1.25, k
            assert 0.7 < gx / wx < 1.4, k


# ---------------------------------------------------------------------------
# the plain pieces (confild_tpu/models/cnf.py:148-290, models/mlp.py)
# ---------------------------------------------------------------------------

def _grad_check(jfn, jparams, port, x, name="plain"):
    """Forward and parameter gradients of a module against a JAX function
    of ``(params, x)``, the parameters carried by the generic converter."""
    port.load_state_dict(convert.nf_state_dict_from_jax("SIRENAutodecoder_film", jparams))
    want = np.asarray(jfn(jparams, x))
    g = np.random.default_rng(9).standard_normal(want.shape).astype(np.float32)
    jgrads = convert.nf_state_dict_from_jax(
        "SIRENAutodecoder_film", jax.grad(lambda p: jnp.sum(jfn(p, x) * g))(jparams))
    out = port(t(x))
    np.testing.assert_allclose(_np(out), want, err_msg=name, **TOL)
    (out * t(g)).sum().backward()
    for k, p in port.named_parameters():
        _close_grad(p.grad, jgrads[k], f"{name} {k}")


X = np.random.default_rng(4).uniform(-1, 1, (5, 7, 3)).astype(np.float32)


def test_plain_siren_matches_jax():
    cfg = jcnf.SirenConfig(3, 2, 2, 16)
    params = jax.tree.map(np.asarray, jcnf.init_siren(jax.random.key(0), cfg))
    port = tcnf.init_siren(tcnf.SirenConfig(3, 2, 2, 16))
    _grad_check(lambda p, x: jcnf.siren_apply(p, x), params, port, X)
    assert tcnf.param_count(port) == jcnf.param_count(params)


@pytest.mark.parametrize("mode", ["basic", "gaussian", "positional"])
def test_feature_mapping_matches_jax(mode):
    jcfg = jcnf.FeatureMappingConfig(3, mode=mode, map_size=8, map_scale=2.0, num_freqs=3)
    tcfg = tcnf.FeatureMappingConfig(3, mode=mode, map_size=8, map_scale=2.0, num_freqs=3)
    params = jax.tree.map(np.asarray, jcnf.init_feature_mapping(jax.random.key(0), jcfg))
    port = tcnf.init_feature_mapping(tcfg)
    assert port.dim == jcfg.dim
    fn = lambda p, x: jcnf.feature_mapping_apply(p, jcfg, x)   # noqa: E731
    if mode == "gaussian":
        _grad_check(fn, params, port, X, mode)
    else:
        np.testing.assert_allclose(_np(port(t(X))), np.asarray(fn(params, X)), **TOL)


@pytest.mark.parametrize("filter_type", ["fourier", "gabor"])
def test_mfn_matches_jax(filter_type):
    jcfg = jcnf.MFNConfig(3, 2, 2, 16, input_scale=8.0, filter_type=filter_type)
    params = jax.tree.map(np.asarray, jcnf.init_mfn(jax.random.key(0), jcfg))
    port = tcnf.init_mfn(tcnf.MFNConfig(3, 2, 2, 16, input_scale=8.0,
                                        filter_type=filter_type))
    _grad_check(lambda p, x: jcnf.mfn_apply(p, jcfg, x), params, port, X, filter_type)


@pytest.mark.parametrize("nonlinearity", sorted(tmlp.NLS_AND_INITS))
@pytest.mark.parametrize("rez", [False, True])
def test_mlps_match_jax(nonlinearity, rez):
    if rez:
        jcfg = jmlp.MLPRezConfig(3, 2, 2, 16, nonlinearity, num_layers_per_block=2)
        tcfg = tmlp.MLPRezConfig(3, 2, 2, 16, nonlinearity, num_layers_per_block=2)
        init, apply = jmlp.init_mlp_reznet, jmlp.mlp_reznet_apply
    else:
        jcfg = jmlp.MLPConfig(3, 2, 2, 16, nonlinearity, outermost_linear=False)
        tcfg = tmlp.MLPConfig(3, 2, 2, 16, nonlinearity, outermost_linear=False)
        init, apply = jmlp.init_mlp, jmlp.mlp_apply
    params = jax.tree.map(np.asarray, init(jax.random.key(0), jcfg))
    port = tmlp.init_mlp(tcfg)
    _grad_check(lambda p, x: apply(p, jcfg, x), params, port, X, nonlinearity)


def test_mlp_init_draws_the_jax_distributions():
    for name in tmlp.NLS_AND_INITS:
        jcfg = jmlp.MLPConfig(64, 64, 1, 64, name)
        want = convert.nf_state_dict_from_jax("SIRENAutodecoder_film", jax.tree.map(
            np.asarray, jmlp.init_mlp(jax.random.key(1), jcfg)))
        got = tmlp.init_mlp(tmlp.MLPConfig(64, 64, 1, 64, name),
                            torch.Generator().manual_seed(1)).state_dict()
        for k in want:
            if want[k].numel() >= 256:
                ws, gs = want[k].std().item(), got[k].std().item()
                assert 0.8 < gs / ws < 1.25, (name, k)


# ---------------------------------------------------------------------------
# convert: the round trip and the optimizer state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SIRENAutodecoder_tw_film", "GNAutodecoder_film",
                                  "SIRENAutodecoder_mdf_film"])
def test_convert_round_trip(tmp_path, name):
    """JAX pytree -> state dict -> the port's parameters read back as the
    same arrays (dense kernels transposed, other leaves as they are), and
    an optax Adam state's moments under the same keys."""
    _, params, port = _pair(name)
    sd = port.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if keys[-1] == "kernel":
            got = sd[".".join(keys[:-1] + ["weight"])].numpy().T
        else:
            got = sd[".".join(keys)].numpy()
        np.testing.assert_array_equal(got, leaf)
    # a pickled optax Adam state, read without optax
    state = optax.adam(1e-3).init(jax.tree.map(jnp.asarray, params))
    moved = jax.tree.map(lambda a: np.asarray(a) + 1.0, state[0].mu)
    save_pytree(str(tmp_path / "opt.ckpt"), (state[0]._replace(mu=moved),) + state[1:])
    adam = convert.adam_state_from_jax(convert.read_ckpt(str(tmp_path / "opt.ckpt")),
                                       "decoder")
    assert sorted(adam) == sorted(sd)
    for k, v in adam.items():
        np.testing.assert_array_equal(v["exp_avg"].numpy(),
                                      convert.nf_state_dict_from_jax(name, moved)[k].numpy())
    with pytest.raises(KeyError):
        convert.nf_state_dict_from_jax("nope", params)


# ---------------------------------------------------------------------------
# the CNF trainer on the zoo (the repaired fault) against the JAX trainer
# ---------------------------------------------------------------------------

def _zoo_case(root, name, epochs, **extra):
    nf = {"name": name, "num_hidden_layers": 2, "out_features": 2, "hidden_features": 32}
    if name == "FNAutodecoder_film":
        nf["kwargs"] = dict(out_features=2, num_hidden_layers=2, hidden_features=32,
                            input_scale=16.0)
    return make_case(root, epochs=epochs, NF=nf, **extra)


@pytest.mark.parametrize("name", TRAINED)
def test_zoo_trainer_matches_jax(tmp_path, name):
    """A CNF recipe naming a zoo decoder trains in both packages (the port
    raised ``KeyError`` in ``create_nf`` before, then took the FiLM route
    regardless of the name): two epochs from the JAX trainer's initial
    decoder, the same permutations; latents, every decoder parameter
    (``tw_film``'s ``w0`` moves) and every logged loss agree, and the port
    resumes from the JAX trainer's ``.ckpt`` at its state."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jtr = JTrainer(_zoo_case(tmp_path / "jax", name, 2))
    _zoo_case(tmp_path / "torch", name, 2, device="cpu")
    ttr = TTrainer(tconfig.basic_input(str(tmp_path / "torch" / "case.yml")))
    assert not ttr.use_fused_decode and ttr.w0 is None
    jtr.state = jtr.init_state()
    ttr.init_state(convert.nf_state_dict_from_jax(name, jax.tree.map(np.asarray,
                                                                     jtr.state.nf_params)))
    w0_start = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    np.testing.assert_allclose(_np(ttr.state.latents), np.asarray(jtr.state.latents),
                               **TRAJ_TOL)
    want = convert.nf_state_dict_from_jax(name, jax.tree.map(np.asarray, jtr.state.nf_params))
    for k, v in ttr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TRAJ_TOL)
    if name == "SIRENAutodecoder_tw_film":
        assert not torch.equal(ttr.model.w0, w0_start["w0"])
    jloss = _csv_column(jtr.hp.save_path, "loss")
    tloss = _csv_column(ttr.hp.save_path, "loss")
    assert len(tloss) == len(jloss) == 2
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    # the port resumes from the JAX trainer's checkpoint (decoder, latents,
    # both Adam states)
    recipe = yaml.safe_load((tmp_path / "jax" / "case.yml").read_text())
    recipe["device"] = "cpu"
    (tmp_path / "resume.yml").write_text(yaml.safe_dump(recipe))
    res = TTrainer(tconfig.basic_input(str(tmp_path / "resume.yml")))
    st = res.load(-1)
    assert st.epoch == int(jtr.state.epoch)
    np.testing.assert_allclose(_np(st.latents), np.asarray(jtr.state.latents), rtol=1e-6)
    for k, v in res.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, rtol=1e-6)


def _csv_column(save_path, key):
    import csv
    with open(os.path.join(save_path, "progress.csv")) as f:
        return [float(r[key]) for r in csv.DictReader(f) if r.get(key)]


@pytest.mark.parametrize("name", ["SIRENAutodecoder_tw_film", "GNAutodecoder_film"])
def test_zoo_cli_checkpoint_and_resume(tmp_path, name):
    """``cli.train_cnf`` on a zoo recipe: two epochs write ``.pt``
    checkpoints holding the zoo decoder's keys, and a second call resumes
    from the newest, continuing the epoch count from the saved decoder,
    latents and optimizers; ``infer``, ``CNF_inference`` and
    ``cli.eval_cnf`` decode through the zoo decoder."""
    _zoo_case(tmp_path, name, 2, device="cpu")
    path = str(tmp_path / "case.yml")
    tr = train_cnf.main([path])
    assert tr.state.epoch == 1
    saved = torch.load(os.path.join(tr.hp.save_path, "checkpoint_1.pt"), weights_only=True)
    assert sorted(saved["model_state_dict"]) == sorted(tr.model.state_dict())
    assert np.all(np.isfinite(tr.eval_rmae()))
    again = TTrainer(tconfig.basic_input(path))
    st = again.load(-1)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    assert torch.equal(st.latents.detach(), tr.state.latents.detach())
    recipe = yaml.safe_load(open(path))
    recipe["epochs"] = 1
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    tr2 = train_cnf.main([path])       # resumes at the saved epoch, as JAX's
    assert tr2.state.epoch == 1
    assert not torch.equal(tr2.state.latents.detach(), tr.state.latents.detach())
    fields = tr2.infer(None, _np(tr2.state.latents[:3]))
    assert fields.shape == (3, 120, 2) and torch.all(torch.isfinite(fields))
    # the checkpoint decodes through CNF_inference and cli.eval_cnf (the
    # plain route: a zoo decoder never takes the kernels)
    ck = os.path.join(tr2.hp.save_path, "checkpoint_1.pt")
    yml = tmp_path / "cnf.yml"
    yml.write_text(yaml.safe_dump({k: recipe[k] for k in ("dims", "hidden_size", "NF")}))
    inf = CNF_inference(ck, str(yml), data_path=recipe["data_path"], device="cpu")
    assert type(inf.model) is type(tr2.model)
    pred = inf.predict(tr2.train_coord, [0, 1, 2])
    np.testing.assert_allclose(pred, fields.numpy(), rtol=1e-5, atol=1e-6)
    mse, rmae = eval_cnf.main(["--checkpoint", ck, "--config", str(yml), "--data",
                               recipe["data_path"], "--coords", recipe["coor_path"],
                               "--device", "cpu"])
    assert mse.shape == rmae.shape == (2,) and np.all(np.isfinite(mse))
