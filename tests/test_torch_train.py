"""Port vs JAX package for the CNF training slice: the training backward's
plain version (the JAX ``_decode_bwd_kernel`` in interpret mode, as
``tests/test_siren_decode.py`` runs it), the train and general decode ops'
gradients, the trainer's trajectory, its numpy-side helpers, its
checkpoints, and resuming from a JAX ``.ckpt`` with JAX and optax blocked.

Tolerances: the backward's cotangents are f32 evaluations of the same
recompute-and-walk-back summed in another order (rtol 1e-4, atol 1e-5); the
trainer's trajectories are held at the JAX package's own fused-vs-jnp
training tolerance (``tests/test_cnf_trainer.py:303-325``).
"""

import copy
import csv
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from confild_tpu.core import normalize as jnorm
from confild_tpu.ops import siren_decode as jsd
from confild_tpu.train import schedulers as jsched
from confild_tpu.train.cnf_trainer import CNFTrainer as JTrainer
from confild_tpu.train.cnf_trainer import rMAE as j_rmae
from confild_tpu.utils import readdata as jread
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.cli import train_cnf
from confild_tpu_torch.core import normalize as tnorm
from confild_tpu_torch.inference import CNF_inference
from confild_tpu_torch.io import checkpoint as tckpt
from confild_tpu_torch.io.convert import cnf_state_dict_from_jax
from confild_tpu_torch.ops import siren_decode as tsd
from confild_tpu_torch.train import schedulers as tsched
from confild_tpu_torch.train.cnf_trainer import CNFTrainer as TTrainer
from confild_tpu_torch.train.cnf_trainer import rMAE as t_rmae
from confild_tpu_torch.utils import readdata as tread
from test_cnf_trainer import make_case
from torch_parity_utils import jax_siren, limit_torch_threads, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_TOL = dict(rtol=5e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# the training backward and the decode ops' gradients
# ---------------------------------------------------------------------------

BWD_CASES = {
    "3-layers": dict(c_in=3, latent=16, c_out=3, layers=2, hidden=32, t=5, m=300),
    "one-modulated-layer": dict(c_in=2, latent=8, c_out=2, layers=0, hidden=32, t=3, m=64),
    "ragged": dict(c_in=3, latent=8, c_out=1, layers=1, hidden=64, t=7, m=37),
}


def _bwd_case(name, seed=0):
    c = BWD_CASES[name]
    params, model = jax_siren(c_in=c["c_in"], latent=c["latent"], c_out=c["c_out"],
                              layers=c["layers"], hidden=c["hidden"], seed=seed)
    rng = np.random.default_rng(seed + 10)
    coords = rng.uniform(-1, 1, (c["m"], c["c_in"])).astype(np.float32)
    latents = (0.1 * rng.standard_normal((c["t"], c["latent"]))).astype(np.float32)
    g = rng.standard_normal((c["t"], c["m"], c["c_out"])).astype(np.float32)
    return params, model, coords, latents, g


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_decode_bwd_plain_matches_pallas_interpret(case):
    """Every cotangent leaf and dlatents of ``fused_siren_decode_bwd``
    (plain version on the CPU) against ``_decode_bwd_kernel`` in interpret
    mode."""
    params, model, coords, latents, g = _bwd_case(case)
    jdp, jdl = jsd.fused_siren_decode_bwd(params, coords, latents, g, 30.0, 8, 128, True)
    grads, dlatents = tsd.fused_siren_decode_bwd(model, t(coords), t(latents), t(g))
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jdp))
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(grads[k]), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(_np(dlatents), np.asarray(jdl), rtol=1e-4, atol=1e-5)


def test_decode_bwd_plain_matches_float64():
    """The plain version's folded cotangents against float64 autograd of the
    reference decode (``torch.sin``), through the same folding."""
    params, model, coords, latents, g = _bwd_case("3-layers", seed=4)
    model64 = copy.deepcopy(model).double()
    lat = t(latents).double().requires_grad_(True)
    out = tsd.siren_film_apply(model64, t(coords).double()[None], lat[:, None], 30.0)
    (out * t(g).double()).sum().backward()
    grads, dlatents = tsd.fused_siren_decode_bwd(model, t(coords), t(latents), t(g))
    np.testing.assert_allclose(_np(dlatents), lat.grad.numpy(), rtol=5e-3, atol=1e-4)
    for name, p in model64.named_parameters():
        np.testing.assert_allclose(_np(grads[name]), p.grad.numpy(), rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def test_train_op_grads_match_jax_vjp():
    """Autograd through the port's ``fused_siren_decode_train`` against
    ``jax.vjp`` of the JAX op (interpret mode); coords get no gradient."""
    params, model, coords, latents, g = _bwd_case("3-layers", seed=1)
    out, vjp = jax.vjp(lambda p, z: jsd.fused_siren_decode_train(
        p, coords, z, 30.0, 8, 128, True), params, latents)
    jdp, jdl = vjp(g)
    lat = t(latents).requires_grad_(True)
    c = t(coords).requires_grad_(True)
    ours = tsd.fused_siren_decode_train(model, c, lat)
    np.testing.assert_allclose(_np(ours), np.asarray(out), rtol=1e-5, atol=2e-6)
    (ours * t(g)).sum().backward()
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jdp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(lat.grad.numpy(), np.asarray(jdl), rtol=1e-4, atol=1e-5)
    assert c.grad is None


def test_general_op_dcoords_chunked_matches_jax(monkeypatch):
    """The general op's coordinate gradient (chunked plain recompute) with
    ``BWD_CHUNK`` forced small in both packages; it must also equal the
    port's own one-chunk result."""
    params, model, coords, latents, g = _bwd_case("3-layers", seed=2)
    monkeypatch.setattr(jsd, "BWD_CHUNK", 128)
    want = jax.grad(lambda c: jnp.sum(jsd.fused_siren_decode(
        params, c, latents, 30.0, 2, 128, True) * g))(coords)

    def port_dcoords():
        c = t(coords).requires_grad_(True)
        (tsd.fused_siren_decode(model, c, t(latents)) * t(g)).sum().backward()
        return c.grad.numpy()

    direct = port_dcoords()                      # m = 300 <= BWD_CHUNK
    monkeypatch.setattr(tsd, "BWD_CHUNK", 128)   # three chunks
    chunked = port_dcoords()
    np.testing.assert_allclose(chunked, direct, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(chunked, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_general_op_param_grads_match_jax():
    """The general op's decoder and latent gradients against ``jax.grad``
    of the JAX general op (interpret mode)."""
    params, model, coords, latents, g = _bwd_case("ragged", seed=3)
    jdp, jdl = jax.grad(lambda p, z: jnp.sum(jsd.fused_siren_decode(
        p, coords, z, 30.0, 2, 128, True) * g), argnums=(0, 1))(params, latents)
    lat = t(latents).requires_grad_(True)
    (tsd.fused_siren_decode(model, t(coords), lat) * t(g)).sum().backward()
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jdp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(lat.grad.numpy(), np.asarray(jdl), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# numpy-side helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,dim", [("-11", 0), ("-11", None), ("01", 0), ("ms", 0),
                                        ("ms", None), ("none", 0)])
def test_normalizer_fit_matches_jax(method, dim):
    data = np.random.default_rng(5).standard_normal((6, 40, 3)).astype(np.float32)
    j = jnorm.Normalizer((), method, dim)
    p = tnorm.Normalizer((), method, dim)
    np.testing.assert_array_equal(p.fit_normalize(data), np.asarray(j.fit_normalize(data)))
    if method != "none":
        for a, b in zip(p.get_params(), j.get_params()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rmae_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.standard_normal((4, 50, 3)).astype(np.float32)
    target = rng.standard_normal((4, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(t_rmae(t(pred), t(target), (1,)).numpy(),
                               np.asarray(j_rmae(pred, target, (1,))), rtol=1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(init_lr=1e-3, init_decay_epochs=50, min_decay_lr=1e-5),
    dict(init_lr=1e-3, init_decay_epochs=50, min_decay_lr=1e-5, restart_interval=20,
         restart_lr=5e-4),
    dict(init_lr=1e-3, init_decay_epochs=50, min_decay_lr=1e-5, restart_interval=10,
         restart_interval_multiplier=2.0),
], ids=["constant-tail", "fixed-restarts", "geometric-restarts"])
def test_cyclic_cosine_decay_matches_jax(kwargs):
    ours, ref = tsched.cyclic_cosine_decay(**kwargs), jsched.cyclic_cosine_decay(**kwargs)
    steps = range(0, 400, 3)
    np.testing.assert_allclose([ours(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-5, atol=1e-10)


def test_cosine_decay_schedule_matches_optax():
    ours = tsched.cosine_decay_schedule(1e-3, 40, alpha=0.01)
    ref = optax.cosine_decay_schedule(1e-3, 40, alpha=0.01)
    steps = range(0, 60)
    # optax evaluates in float32, the port in float64
    np.testing.assert_allclose([ours(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-5)


def test_readdata_registry_matches_jax(tmp_path):
    data = np.arange(60, dtype=np.float32).reshape(5, 4, 3)
    np.save(tmp_path / "d.npy", data)
    assert sorted(tread.REGISTRY) == sorted(jread.REGISTRY)
    for name in tread.REGISTRY:
        np.testing.assert_array_equal(tread.get_loader(name)(str(tmp_path / "d.npy")),
                                      jread.get_loader(name)(str(tmp_path / "d.npy")))
    np.testing.assert_array_equal(
        tread.load_channel_flow(str(tmp_path / "d.npy"), 1, 5, 2), data[1:5:2])
    with pytest.raises(KeyError):
        tread.get_loader("nope")


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer
# ---------------------------------------------------------------------------

def _csv_rows(save_path):
    with open(os.path.join(save_path, "progress.csv")) as f:
        return list(csv.DictReader(f))


def _pair(tmp_path, epochs=4, **extra):
    """The same toy case for both trainers, the port starting from the JAX
    trainer's initial decoder (carried across by ``convert``)."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jhp = make_case(tmp_path / "jax", epochs=epochs, **extra)
    make_case(tmp_path / "torch", epochs=epochs, device="cpu", **extra)
    thp = tconfig.basic_input(str(tmp_path / "torch" / "case.yml"))
    jtr, ttr = JTrainer(jhp), TTrainer(thp)
    jtr.state = jtr.init_state()
    ttr.init_state(cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.state.nf_params)))
    return jtr, ttr


def _assert_same_state(jtr, ttr):
    np.testing.assert_allclose(_np(ttr.state.latents), np.asarray(jtr.state.latents),
                               **TRAJ_TOL)
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.state.nf_params))
    for k, v in ttr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TRAJ_TOL)


TRAINER_CASES = {
    "epoch-cadence": {},
    "batch-cadence": {"nf_optim_cadence": "batch"},
    "lr-tails": {"lr": {"nf": 1e-3, "latents": 1e-2, "nf_end": 1e-5,
                        "latents_end": 1e-4, "decay_epochs": 3}},
    "latent-l2": {"latent_l2": 0.1, "lr": {"nf": 1e-3, "latents": 1e-2}},
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_matches_jax(tmp_path, case):
    """Four epochs on ``make_case``: latents, decoder and every logged loss
    and eval agree with the JAX trainer (fused decode on both sides)."""
    jtr, ttr = _pair(tmp_path, **TRAINER_CASES[case])
    assert ttr.use_fused_decode and jtr.use_fused_decode
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    assert ttr.state.epoch == int(jtr.state.epoch) == 3
    _assert_same_state(jtr, ttr)
    jrows, trows = _csv_rows(jtr.hp.save_path), _csv_rows(ttr.hp.save_path)
    assert [r["epoch"] for r in trows] == [r["epoch"] for r in jrows]
    for key in ("loss", "test_error_0", "test_error_1"):
        a = [float(r[key]) for r in trows if r.get(key)]
        b = [float(r[key]) for r in jrows if r.get(key)]
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=key)
    # the checkpoints the two trainers wrote hold the same epochs
    assert sorted(f.split(".")[0] for f in os.listdir(ttr.hp.save_path)
                  if f.startswith("checkpoint_")) == \
        sorted(f.split(".")[0] for f in os.listdir(jtr.hp.save_path)
               if f.startswith("checkpoint_"))


def test_unfused_trainer_matches_jax_and_fused(tmp_path):
    """``use_fused_decode: false`` (the plain autograd decode) against the
    JAX jnp path, and against the port's fused path."""
    jtr, ttr = _pair(tmp_path, use_fused_decode=False)
    assert not ttr.use_fused_decode
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    _assert_same_state(jtr, ttr)
    (tmp_path / "fused").mkdir()
    make_case(tmp_path / "fused", epochs=4, device="cpu")
    fused = TTrainer(tconfig.basic_input(str(tmp_path / "fused" / "case.yml")))
    fused.init_state(cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.init_state().nf_params)))
    fused.train(log_formats=())
    np.testing.assert_allclose(_np(fused.state.latents), _np(ttr.state.latents), **TRAJ_TOL)


def test_eval_counts_every_sample_with_ragged_tail(tmp_path):
    """13 snapshots in eval chunks of 8: the tail counts, and the eval
    agrees with the JAX trainer's padded, masked eval and with a direct
    full-set rMAE."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(120, 2)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=(13, 1, 1))
    fois = (np.sin(2 * np.pi * coords[None, :, :1] + phase)
            * np.array([1.0, 0.5])).astype(np.float32)
    jtr, ttr = None, None
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        make_case(tmp_path / side, epochs=2, device="cpu")
        np.save(tmp_path / side / "fois.npy", fois)
        np.save(tmp_path / side / "coords.npy", coords)
    from confild_tpu import config as jconfig
    jtr = JTrainer(jconfig.basic_input(str(tmp_path / "jax" / "case.yml")))
    ttr = TTrainer(tconfig.basic_input(str(tmp_path / "torch" / "case.yml")))
    jtr.state = jtr.init_state()
    ttr.init_state(cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.state.nf_params)))
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    got = ttr.eval_rmae()
    _, eval_rmae, _ = jtr._build_train_fns(False)
    np.testing.assert_allclose(got, np.asarray(eval_rmae(jtr.state)), rtol=1e-4)
    pred = ttr.infer(ttr.train_coord, ttr.state.latents)
    want = t_rmae(pred, t(fois), (1,)).mean(dim=0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

def _port_case(tmp_path, epochs, **extra):
    make_case(tmp_path, epochs=epochs, device="cpu", **extra)
    return tconfig.basic_input(str(tmp_path / "case.yml"))


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A fresh trainer's load(-1) restores decoder, latents and both Adam
    states from the newest .pt; training on continues the epoch count and
    matches an uninterrupted run of the same epochs."""
    hp = _port_case(tmp_path, epochs=6)
    tr = TTrainer(hp)
    assert tr.load(-1) is None               # nothing yet: from scratch
    tr.train(log_formats=())
    assert tr.state.epoch == 5
    names = sorted(os.listdir(hp.save_path))
    assert "checkpoint_5.pt" in names and "normalizer_params.pt" in names

    tr2 = TTrainer(hp)
    st = tr2.load(-1)
    assert st is not None and st.epoch == 5
    np.testing.assert_array_equal(_np(st.latents), _np(tr.state.latents))
    for (k, a), b in zip(tr2.model.state_dict().items(), tr.model.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    for o2, o1 in ((st.opt_nf, tr.state.opt_nf), (st.opt_lat, tr.state.opt_lat)):
        for p2, p1 in zip(o2.param_groups[0]["params"], o1.param_groups[0]["params"]):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(o2.state[p2][key].numpy(),
                                              o1.state[p1][key].numpy())
    hp.epochs = 2
    tr2.train(log_formats=())
    assert tr2.state.epoch == 6

    # the checkpoint and normalizer the trainer writes load through the
    # port's CNF_inference
    (tmp_path / "cnf.yml").write_text(
        "dims: 2\nhidden_size: 16\nNF:\n  name: SIRENAutodecoder_film\n"
        "  out_features: 2\n  num_hidden_layers: 2\n  hidden_features: 32\n")
    inf = CNF_inference(os.path.join(hp.save_path, "checkpoint_6.pt"),
                        str(tmp_path / "cnf.yml"), device="cpu")
    got = inf.predict(tr2.train_coord, [0, 3], batch_size=2)
    want = tr2.infer(tr2.train_coord, tr2.state.latents[[0, 3]]).numpy()
    # fused polynomial-sine decode vs the torch.sin reference decode
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_keep_checkpoints_rotation_and_latest(tmp_path):
    hp = _port_case(tmp_path, epochs=12, keep_checkpoints=2)
    TTrainer(hp).train(log_formats=())
    kept = sorted(f for f in os.listdir(hp.save_path) if f.startswith("checkpoint_"))
    assert kept == ["checkpoint_10.pt", "checkpoint_11.pt"]
    assert tckpt.latest_checkpoint(hp.save_path) == (
        os.path.join(hp.save_path, "checkpoint_11.pt"), 11)
    # a stranded ``.old`` generation is renamed back before the search
    os.rename(os.path.join(hp.save_path, "checkpoint_11.pt"),
              os.path.join(hp.save_path, "checkpoint_11.pt.old"))
    assert tckpt.latest_checkpoint(hp.save_path)[1] == 11
    assert tckpt.parse_resume_step("run/model004200.pt") == 4200
    # rotation leaves files that are not the port's checkpoints alone
    open(os.path.join(hp.save_path, "checkpoint_3.ckpt"), "wb").close()
    assert tckpt.rotate_checkpoints(hp.save_path, 1) == [
        os.path.join(hp.save_path, "checkpoint_10.pt")]
    assert os.path.exists(os.path.join(hp.save_path, "checkpoint_3.ckpt"))


def test_siren_only_sizes_latents_from_current_dataset(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    hp_a = _port_case(tmp_path / "a", epochs=4)
    tr_a = TTrainer(hp_a)
    tr_a.train(log_formats=())
    hp_b = _port_case(tmp_path / "b", epochs=2)
    np.save(tmp_path / "b" / "fois.npy", np.load(tmp_path / "a" / "fois.npy")[:10])
    hp_b.save_path = hp_a.save_path
    tr_b = TTrainer(hp_b)
    st = tr_b.load(-1, siren_only=True)
    assert tr_b.N_samples == 10 and tuple(st.latents.shape) == (10, 16)
    assert not st.latents.detach().any()
    assert not st.opt_lat.state                       # fresh latent optimizer
    assert st.opt_nf.state                            # decoder optimizer carried
    assert st.epoch == tr_a.state.epoch
    for a, b in zip(tr_b.model.state_dict().values(), tr_a.model.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_zero_epoch_train_keeps_epoch(tmp_path):
    hp = _port_case(tmp_path, epochs=4)
    tr = TTrainer(hp)
    tr.train(log_formats=())
    before = _np(tr.state.latents).copy()
    hp.epochs = 0
    st = tr.train(log_formats=())
    assert st.epoch == 3
    np.testing.assert_array_equal(_np(st.latents), before)


def test_latent_noise_is_seeded_and_latent_init(tmp_path):
    """``latent_noise_std`` draws from a generator seeded per epoch and
    batch: two runs agree bitwise and differ from the noise-free run;
    ``latent_init`` seeds the table and rejects a wrong shape."""
    runs = []
    for name, extra in (("a", {"latent_noise_std": 0.05}), ("b", {"latent_noise_std": 0.05}),
                        ("c", {})):
        (tmp_path / name).mkdir()
        tr = TTrainer(_port_case(tmp_path / name, epochs=3, **extra))
        tr.init_state(seed=0)
        tr.train(log_formats=())
        runs.append(_np(tr.state.latents))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.allclose(runs[0], runs[2])
    init = np.linspace(-0.3, 0.3, 16 * 16).reshape(16, 16).astype(np.float32)
    np.save(tmp_path / "zinit.npy", init)
    (tmp_path / "d").mkdir()
    tr = TTrainer(_port_case(tmp_path / "d", epochs=1, latent_init=str(tmp_path / "zinit.npy")))
    np.testing.assert_array_equal(_np(tr.init_state().latents), init)
    np.save(tmp_path / "bad.npy", init[:4])
    (tmp_path / "e").mkdir()
    with pytest.raises(ValueError, match="latent_init"):
        TTrainer(_port_case(tmp_path / "e", epochs=1,
                            latent_init=str(tmp_path / "bad.npy"))).init_state()


def test_unported_options_raise(tmp_path, capsys):
    # multiGPU: 2 in one process trains on one device without a mesh, as
    # the JAX CLI maps it onto min(multiGPU, devices)
    hp = _port_case(tmp_path, epochs=1, multiGPU=2)
    tr = train_cnf.main([str(tmp_path / "case.yml")])
    assert tr.mesh is None and tr.state.epoch == 0
    assert np.all(np.isfinite(_np(tr.state.latents)))
    assert "multiGPU" not in capsys.readouterr().out
    # a JAX Orbax directory raises, saying how to rewrite it as one file
    os.makedirs(os.path.join(hp.save_path, "checkpoint_7.ckpt"))
    with pytest.raises(NotImplementedError, match="load_pytree.*save_pytree|save_pytree"):
        TTrainer(hp).load(-1)
    # extra_siren_in is ported (tests/test_torch_extra_in.py); a count of
    # extra values that the data's second axis does not hold is refused
    hp = _port_case(tmp_path, epochs=1, extra_siren_in=4)
    with pytest.raises(ValueError, match="extra_siren_in"):
        TTrainer(hp)
    # TensorBoard logging is ported now (the diffusion CLI asks for it): it
    # writes scalars, or nothing where the tensorboard package is missing
    from confild_tpu_torch.utils import logger as tlog
    logger = tlog.configure(str(tmp_path / "log"), ["tensorboard"])
    logger.logkv_mean("loss", 1.0)
    logger.logkv_mean("loss", 2.0)
    assert logger.dumpkvs() == {"loss": 1.5}
    logger.close()


RESUME_WITHOUT_JAX = r"""
import copy
import sys
sys.modules["jax"] = None
sys.modules["optax"] = None
import torch
from confild_tpu_torch import config
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
tr = CNFTrainer(config.basic_input(sys.argv[1]))
st = tr.load(-1)
out = copy.deepcopy({
    "epoch": st.epoch, "latents": st.latents.detach(), "model": tr.model.state_dict(),
    "nf": {n: dict(st.opt_nf.state[p]) for n, p in tr.model.named_parameters()},
    "lat": dict(st.opt_lat.state[st.latents])})
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "optax")
             and sys.modules[k] is not None)
assert not bad, bad
tr.train(log_formats=())
out["epoch_after"] = tr.state.epoch
torch.save(out, sys.argv[2])
"""


def test_resume_from_jax_ckpt_without_jax(tmp_path):
    """The JAX trainer writes real ``checkpoint_*.ckpt`` files (optax
    states pickled); a process where importing jax or optax fails resumes
    the port's trainer from them: decoder, latents and both Adam states
    match the pickled ones, and training continues the epoch."""
    hp = make_case(tmp_path, epochs=2, device="cpu",
                   lr={"nf": 1e-4, "latents": 1e-3, "nf_end": 1e-5, "decay_epochs": 4})
    jtr = JTrainer(hp)
    jtr.train(log_formats=())
    s = jtr.state
    with open(os.path.join(hp.save_path, "checkpoint_1.ckpt"), "rb") as f:
        assert b"optax" in f.read()
    out = tmp_path / "resumed.pt"
    proc = subprocess.run(
        [sys.executable, "-c", RESUME_WITHOUT_JAX, str(tmp_path / "case.yml"), str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(out, weights_only=True)
    assert got["epoch"] == 1 and got["epoch_after"] > 1
    np.testing.assert_array_equal(got["latents"].numpy(), np.asarray(s.latents))
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, s.nf_params))
    for k, v in want.items():
        np.testing.assert_array_equal(got["model"][k].numpy(), v.numpy(), err_msg=k)
    adam_nf, adam_lat = s.opt_nf_state[0], s.opt_lat_state[0]
    mu = cnf_state_dict_from_jax(jax.tree.map(np.asarray, adam_nf.mu))
    nu = cnf_state_dict_from_jax(jax.tree.map(np.asarray, adam_nf.nu))
    for k in want:
        st = got["nf"][k]
        assert float(st["step"]) == float(adam_nf.count) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[k].numpy(), err_msg=k)
    assert float(got["lat"]["step"]) == float(adam_lat.count) == 4.0
    np.testing.assert_array_equal(got["lat"]["exp_avg"].numpy(), np.asarray(adam_lat.mu))
    np.testing.assert_array_equal(got["lat"]["exp_avg_sq"].numpy(), np.asarray(adam_lat.nu))


def test_resume_from_jax_ckpt_continues_like_jax(tmp_path):
    """Resuming the same JAX checkpoint in both packages and training two
    more epochs gives the same trajectory (the carried Adam moments and
    schedule counts take effect)."""
    hp = make_case(tmp_path, epochs=3, device="cpu",
                   lr={"nf": 1e-3, "latents": 1e-2, "nf_end": 1e-5, "decay_epochs": 6})
    JTrainer(hp).train(log_formats=())
    jtr = JTrainer(hp)
    jtr.load(-1)
    ttr = TTrainer(tconfig.basic_input(str(tmp_path / "case.yml")))
    ttr.load(-1)
    assert ttr.state.epoch == int(jtr.state.epoch) == 2
    hp.epochs = ttr.hp.epochs = 2
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    _assert_same_state(jtr, ttr)


def test_ckpt_unpickler_refuses_other_modules(tmp_path):
    from confild_tpu_torch.io import convert
    path = tmp_path / "evil.ckpt"
    path.write_bytes(pickle.dumps({"x": os.getcwd}))
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        convert.read_ckpt(str(path))


def test_infer_mode_loads_without_dataset(tmp_path):
    """An infer-mode trainer reads no dataset: the latent table's size
    comes from the checkpoint, and ``infer`` decodes its rows."""
    hp = _port_case(tmp_path, epochs=2)
    tr = TTrainer(hp)
    tr.train(log_formats=())
    inf = TTrainer(hp, infer_mode=True)
    st = inf.load(-1)
    assert inf.N_samples == 16 and st.epoch == 1
    np.testing.assert_array_equal(_np(st.latents), _np(tr.state.latents))
    out = inf.infer(tr.train_coord, st.latents[:3], batch=2)
    np.testing.assert_allclose(out.numpy(), tr.infer(tr.train_coord, tr.state.latents[:3]).numpy())
    assert out.shape == (3, 120, 2)
