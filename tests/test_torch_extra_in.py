"""Port vs JAX package for the extra-input CNF: ``siren_film_extra_in_apply``
and its registry entry ``SIRENAutodecoder_film_extra_in``, and the CNF
trainer's ``extra_siren_in`` (a scalar per sample prepended as a coordinate
channel): its three spec forms, the ``(t, n_extra, *spatial, c)`` layout
flattened into the sample axis, the extra normalizer and its file, and the
training trajectory on the plain route (both packages send this variant
down the plain decode).

Tolerances: the forward is one float32 evaluation of the same layers (rtol
1e-5); the trajectories are held at the port's trainer tolerance
(``tests/test_torch_train.py``: rtol 5e-3, atol 1e-5; logged losses rtol
1e-5).  Mirrors ``tests/test_cnf_trainer.py:208-240``.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from confild_tpu import config as jconfig
from confild_tpu.io.checkpoint import load_pytree
from confild_tpu.models import cnf as jcnf
from confild_tpu.train.cnf_trainer import CNFTrainer as JTrainer
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.io.convert import cnf_state_dict_from_jax
from confild_tpu_torch.models import cnf as tcnf
from confild_tpu_torch.train.cnf_trainer import CNFTrainer as TTrainer
from torch_parity_utils import limit_torch_threads, t

TRAJ_TOL = dict(rtol=5e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _extra_model(seed=0, c_in=3, latent=8, c_out=2, layers=2, hidden=32):
    m = jcnf.create_nf("SIRENAutodecoder_film_extra_in", in_coord_features=c_in,
                       in_latent_features=latent, out_features=c_out,
                       num_hidden_layers=layers, hidden_features=hidden)
    params = jax.tree.map(np.asarray, m.init_params(jax.random.key(seed)))
    port = tcnf.create_nf("SIRENAutodecoder_film_extra_in", in_coord_features=c_in,
                          in_latent_features=latent, out_features=c_out,
                          num_hidden_layers=layers, hidden_features=hidden)
    port.load_state_dict(cnf_state_dict_from_jax(params))
    return m, params, port


@pytest.mark.parametrize("layout", ["flat", "grid"])
def test_extra_in_forward_matches_jax(layout):
    """Per-sample scalars ``(B, 1.., 1)`` against flat ``(N, 2)`` or grid
    ``(n, n, 2)`` coordinates: the port's module and function against
    JAX's apply (f32, rtol 1e-5)."""
    m, params, port = _extra_model()
    rng = np.random.default_rng(1)
    if layout == "flat":
        coords = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    else:
        coords = rng.uniform(0, 1, (6, 5, 2)).astype(np.float32)
    ones = (1,) * (coords.ndim - 1)
    extra = rng.uniform(-1, 1, (3, *ones, 1)).astype(np.float32)
    latents = (0.3 * rng.standard_normal((3, *ones, 8))).astype(np.float32)
    want = np.asarray(m(params, (jnp.asarray(coords), jnp.asarray(extra)),
                        jnp.asarray(latents)))
    with torch.no_grad():
        got = port((t(coords), t(extra)), t(latents)).numpy()
        direct = tcnf.siren_film_extra_in_apply(port, (t(coords), t(extra)), t(latents),
                                                port.w0).numpy()
    assert got.shape == want.shape == (3, *coords.shape[:-1], 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, direct)


def test_extra_in_state_dict_keys_are_the_plain_decoders():
    """``io/convert.py`` carries the extra-input decoder across unchanged:
    the state-dict keys and shapes are the plain SIREN-FiLM's, and the
    extra channel is the first column of the first weight."""
    _, params, port = _extra_model()
    plain = tcnf.create_nf("SIRENAutodecoder_film", in_coord_features=3, in_latent_features=8,
                           out_features=2, num_hidden_layers=2, hidden_features=32)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    assert isinstance(port, tcnf.SirenFilmExtraIn)
    np.testing.assert_array_equal(port.net1[0].weight.detach().numpy(),
                                  params["net1"][0]["kernel"].T)
    assert set(tcnf.NF_REGISTRY) <= set(jcnf.NF_REGISTRY)


T_SNAP, N_EXTRA, N_PTS = 6, 4, 50
SPECS = {"int": 4, "triple": [0.0, 2.0, 4], "list": [0.1, 0.5, 0.7, 1.0]}


def _case(root, spec, **over):
    """The JAX package's parametric toy case (``tests/test_cnf_trainer.py:
    208-236``): (t, n_extra, N, c) data, one channel."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N_PTS, 2)).astype(np.float32)
    levels = np.linspace(0, 1, N_EXTRA, dtype=np.float32)
    fois = np.sin(2 * np.pi * coords[None, None, :, :1]
                  + levels[None, :, None, None]).astype(np.float32)
    fois = np.broadcast_to(fois, (T_SNAP, N_EXTRA, N_PTS, 1)).copy()
    fois = fois * np.linspace(0.5, 1.5, T_SNAP, dtype=np.float32)[:, None, None, None]
    np.save(root / "fois.npy", fois)
    np.save(root / "coords.npy", coords)
    recipe = {
        "data_path": str(root / "fois.npy"), "coor_path": str(root / "coords.npy"),
        "save_path": str(root / "run"), "lumped_latent": True, "extra_siren_in": spec,
        "normalizer": {"method": "-11", "dim": 0},
        "batch_size": 8, "test_batch_size": 8, "multiGPU": 1,
        "readin_data_shape": "t e N c", "batch_shape": "t e N c",
        "hidden_size": 8, "epochs": 4, "loss_fn": "MSELoss",
        "test_criteria": "rMAE", "save_every": 3, "dims": 2,
        "NF": {"name": "SIRENAutodecoder_film_extra_in", "num_hidden_layers": 1,
               "out_features": 1, "hidden_features": 16},
        "lr": {"nf": 1e-3, "latents": 1e-2}, **over,
    }
    (root / "case.yml").write_text(yaml.safe_dump(recipe))
    return str(root / "case.yml")


def _pair(tmp_path, spec, **over):
    jtr = JTrainer(jconfig.basic_input(_case(tmp_path / "jax", spec, **over)))
    ttr = TTrainer(tconfig.basic_input(_case(tmp_path / "torch", spec, device="cpu", **over)))
    jtr.state = jtr.init_state()
    ttr.init_state(cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.state.nf_params)))
    return jtr, ttr


def _rows(save_path):
    with open(os.path.join(save_path, "progress.csv")) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("form", sorted(SPECS))
def test_extra_in_trainer_matches_jax(tmp_path, form):
    """Each spec form: the extra values, the flattened sample axis, the
    three normalizers, the plain route, then four epochs: every logged loss
    and eval, the latents and the decoder agree with the JAX trainer."""
    jtr, ttr = _pair(tmp_path, SPECS[form])
    np.testing.assert_array_equal(ttr.extra_siren_in, jtr.extra_siren_in)
    assert ttr.N_samples == jtr.N_samples == T_SNAP * N_EXTRA
    assert ttr.n_extra == jtr.n_extra == N_EXTRA
    assert tuple(ttr.spatio_shape) == tuple(jtr.spatio_shape) == (N_PTS,)
    assert ttr.spatio_axis == jtr.spatio_axis == [1]
    assert not ttr.use_fused_decode and not jtr.use_fused_decode
    assert isinstance(ttr.model, tcnf.SirenFilmExtraIn)
    assert ttr.model.net1[0].in_features == 3
    for name in ("in_normalizer", "out_normalizer", "extra_in_normalizer"):
        for a, b in zip(getattr(ttr, name).params, getattr(jtr, name).params):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(ttr.normed_extra.numpy(), np.asarray(jtr.normed_extra),
                               rtol=1e-6)
    np.testing.assert_allclose(ttr.normed_fois.numpy(), np.asarray(jtr.normed_fois),
                               rtol=1e-6, atol=1e-7)
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    jrows, trows = _rows(jtr.hp.save_path), _rows(ttr.hp.save_path)
    assert [r["epoch"] for r in trows] == [r["epoch"] for r in jrows]
    for key in ("loss", "test_error_0"):
        a = [float(r[key]) for r in trows if r.get(key)]
        b = [float(r[key]) for r in jrows if r.get(key)]
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(ttr.state.latents.detach().numpy(),
                               np.asarray(jtr.state.latents), **TRAJ_TOL)
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.state.nf_params))
    for k, v in ttr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TRAJ_TOL)
    np.testing.assert_allclose(ttr.eval_rmae(), np.asarray(jtr._train_fns[1](jtr.state)),
                               rtol=1e-4)


def test_extra_in_batch_cadence_matches_jax(tmp_path):
    """The per-batch decoder cadence on the extra-input decoder."""
    jtr, ttr = _pair(tmp_path, 4, nf_optim_cadence="batch")
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    np.testing.assert_allclose(ttr.state.latents.detach().numpy(),
                               np.asarray(jtr.state.latents), **TRAJ_TOL)


def test_extra_normalizer_file_read_by_the_other_package(tmp_path):
    """The JAX trainer's ``normalizer_params.ckpt`` gives the port its extra
    normalizer, and the port's ``normalizer_params.pt`` gives JAX its own:
    each package's three normalizers equal the other's."""
    jtr = JTrainer(jconfig.basic_input(_case(tmp_path / "jax", 4)))
    assert "extra_normalizer_params" in load_pytree(
        str(tmp_path / "jax" / "run" / "normalizer_params.ckpt"))
    # the port reads the JAX file (no fit: a fit would overwrite nothing
    # but would not prove the read)
    path = _case(tmp_path / "torch_reads", 4, device="cpu",
                 save_path=str(tmp_path / "jax" / "run"))
    ttr = TTrainer(tconfig.basic_input(path))
    assert not os.path.exists(tmp_path / "jax" / "run" / "normalizer_params.pt")
    # JAX reads the port's file
    tfit = TTrainer(tconfig.basic_input(_case(tmp_path / "torch", 4, device="cpu")))
    assert os.path.exists(tmp_path / "torch" / "run" / "normalizer_params.pt")
    jread = JTrainer(jconfig.basic_input(_case(tmp_path / "jax_reads", 4,
                                              save_path=str(tmp_path / "torch" / "run"))))
    assert not os.path.exists(tmp_path / "torch" / "run" / "normalizer_params.ckpt")
    for name in ("in_normalizer", "out_normalizer", "extra_in_normalizer"):
        for got, want in ((ttr, jtr), (jread, tfit)):
            for a, b in zip(getattr(got, name).params, getattr(want, name).params):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_extra_count_must_match_the_data(tmp_path):
    """Five extra values for four along the data's second axis: the JAX
    trainer's assert, the port's ValueError."""
    with pytest.raises(AssertionError):
        JTrainer(jconfig.basic_input(_case(tmp_path / "jax", 5)))
    with pytest.raises(ValueError, match="extra_siren_in"):
        TTrainer(tconfig.basic_input(_case(tmp_path / "torch", 5, device="cpu")))
