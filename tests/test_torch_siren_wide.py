"""The SIREN-FiLM kernels' widths above 384, and the demo CNF's, on the CPU.

The CUDA kernels take up to 16 coordinates and outputs; the float32 and
bf16 forwards, dz and the training backward's chain are cluster kernels
at every width up to H = 3072 (a cluster owns 128 pairs, 64 above H =
2048; 448 pads to 512, two blocks of 256 columns).  Here (the width limits are
``test_torch_siren_fwd.py::test_kernel_width_limits``): the plain
versions (what a CPU tensor takes) at H = 448, 512, 640, 1024, 1536,
2048 and 3072, with 5
outputs (the 3-D velocity, pressure and temperature; at 640 and 2048 also
with a single modulated layer), with 16 coordinates
and outputs, and at the turbulence demo's CNF widths (2 coordinates and
outputs), against the JAX package's Pallas kernels in interpret mode, the
weights carried across by ``cnf_state_dict_from_jax`` (forward rtol 1e-5,
dz and the training backward rtol 1e-4, the tolerances of
``tests/test_torch_siren_fwd.py``, ``test_torch_siren_dz.py`` and
``test_torch_train.py``, the backward's absolute floor scaled to each
leaf's magnitude); the dz kernel's row slots and fold cover every pair
once with the cluster chain's 128- and 64-pair clusters, at 448 and 512
and above; and one epoch of the port's
``CNFTrainer`` against the JAX trainer (which trains through its Pallas
kernels at any width) at ``hidden_features`` 640 and ``out_features`` 5.
The kernels themselves run on the card (``chip_smoke.py`` phases 16a, 16c
and 19).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_siren_dz as dz_maps
from confild_tpu.ops import siren_decode as jsd
from confild_tpu.train.cnf_trainer import CNFTrainer as JTrainer
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.io.convert import cnf_state_dict_from_jax
from confild_tpu_torch.ops import siren_decode as tsd
from confild_tpu_torch.train.cnf_trainer import CNFTrainer as TTrainer
from test_cnf_trainer import make_case
from test_torch_train import _assert_same_state, _csv_rows
from torch_parity_utils import jax_siren, limit_torch_threads, t


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


# (c_in, latent, c_out, middle layers, hidden, rows, points): 448 (padded
# to 512) and 512 (two blocks of 256 columns a cluster); those of the cluster kernels with 5 outputs (up to
# 2048, where a cluster owns 128 pairs, and the widest, 3072; also of one
# modulated layer, with no middle weight) and with 16 coordinates and
# outputs; 16 outputs at Case4's width; and
# the turbulence demo CNF's at its f4 widths (7 modulated layers of 384)
# and under --fast (5 of 128), with 2 coordinates and 2 outputs
WIDE = {"448": (3, 16, 3, 2, 448, 3, 200), "512": (2, 16, 2, 1, 512, 2, 150),
        "640-c5": (3, 16, 5, 2, 640, 2, 128), "1024-c5": (3, 16, 5, 1, 1024, 2, 100),
        "1536-c5": (3, 16, 5, 2, 1536, 2, 64), "2048-c5": (3, 16, 5, 1, 2048, 2, 48),
        "3072-c5": (3, 16, 5, 1, 3072, 2, 32), "640-c5-n1": (3, 16, 5, 0, 640, 2, 64),
        "2048-c5-n1": (3, 16, 5, 0, 2048, 2, 48),
        "1024-c16": (16, 16, 16, 1, 1024, 2, 64), "384-c16": (3, 16, 16, 2, 384, 2, 128),
        "demo-f4": (2, 16, 2, 6, 384, 2, 150), "demo-fast": (2, 16, 2, 4, 128, 3, 200)}


def _wide(name, seed=0):
    c_in, latent, c_out, layers, hidden, rows, points = WIDE[name]
    params, model = jax_siren(c_in=c_in, latent=latent, c_out=c_out, layers=layers,
                              hidden=hidden, seed=seed)
    rng = np.random.default_rng(seed + 10)
    coords = rng.uniform(-1, 1, (points, c_in)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((rows, latent))).astype(np.float32)
    g = rng.standard_normal((rows, points, c_out)).astype(np.float32)
    return params, model, coords, latents, g


@pytest.mark.parametrize("name", sorted(WIDE))
def test_forward_plain_matches_pallas_interpret(name):
    params, model, coords, latents, _ = _wide(name)
    pallas = np.asarray(jsd._fused_forward(params, jnp.asarray(coords), jnp.asarray(latents),
                                           30.0, 2, 128, True, jnp.float32))
    with torch.no_grad():
        ours = tsd.fused_siren_decode(model, t(coords), t(latents)).numpy()
    assert ours.shape == pallas.shape
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("name", sorted(WIDE))
def test_dz_plain_matches_pallas_interpret(name):
    params, model, coords, latents, g = _wide(name, seed=1)
    pallas = np.asarray(jsd.fused_siren_decode_dz(params, coords, latents, g, 30.0, 8, 128,
                                                  True))
    ours = tsd.fused_siren_decode_dz(model, t(coords), t(latents), t(g)).numpy()
    assert ours.shape == pallas.shape == (latents.shape[0], latents.shape[1])
    np.testing.assert_allclose(ours, pallas, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(WIDE))
def test_bwd_plain_matches_pallas_interpret(name):
    params, model, coords, latents, g = _wide(name, seed=2)
    jdp, jdl = jsd.fused_siren_decode_bwd(params, coords, latents, g, 30.0, 8, 128, True)
    grads, dlatents = tsd.fused_siren_decode_bwd(model, t(coords), t(latents), t(g))
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jdp))
    assert set(grads) == set(want)
    for k in want:
        # f32 sums over the pairs in another order: at these widths a leaf
        # reaches some 700 (dW_head), so the absolute floor is 1e-6 of each
        # leaf's largest magnitude (the floor of the kernels' criterion)
        w = want[k].numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4,
                                   atol=max(1e-5, 1e-6 * np.abs(w).max()), err_msg=k)
    np.testing.assert_allclose(dlatents.numpy(), np.asarray(jdl), rtol=1e-4, atol=1e-5)


def _check_slots_and_fold(monkeypatch, cp, m, rows, chunk):
    """The dz kernel's index maps at units (clusters) of ``cp`` pairs:
    every (row, point) pair in exactly one slot of its own row, and every
    row's slots folded once; a unit needs at most ``dz_slots``."""
    monkeypatch.setattr(dz_maps, "CP", cp)
    pairs = rows * m
    seen = np.zeros(pairs, np.int64)
    for p0, q in tsd.pair_chunks(pairs, chunk):
        blocks = dz_maps._block_slots(p0, q, m)
        assert len(blocks) == -(-q // cp)
        for b, slots in zip(range(0, q, cp), blocks):
            assert slots[-1] + 1 <= dz_maps._dz_slots(m)
            pair = p0 + b + np.arange(len(slots))
            np.testing.assert_array_equal(pair // m - (p0 + b) // m, slots)
        for row, sources in dz_maps._fold_sources(p0, q, m).items():
            for bk, slot in sources:
                slots = blocks[bk]
                hit = p0 + bk * cp + np.flatnonzero(slots == slot)
                assert np.all(hit // m == row) and hit.size
                seen[hit] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("m,rows,chunk", [
    (10, 50, 448), (31, 20, 448), (64, 20, 448), (1000, 3, 448), (1024, 3, 640),
    (10, 384, tsd.BWD_PAIRS), (4096, 64, tsd.BWD_PAIRS),
])
def test_slots_and_fold_cover_every_pair_once_at_448_and_512(monkeypatch, m, rows, chunk):
    """The index maps at H = 448 and 512, whose clusters (two blocks of
    256 columns, 448 padded) own 128 pairs, as the narrower widths' do."""
    cps = {tsd.cluster_plan(h).pairs for h in (448, 512)}
    assert cps == {128}
    _check_slots_and_fold(monkeypatch, cps.pop(), m, rows, chunk)
    assert dz_maps._dz_slots(10) == 14 and dz_maps._dz_slots(64) == 3


@pytest.mark.parametrize("cp", [tsd.cluster_plan(h).pairs for h in (1024, 3072)])
@pytest.mark.parametrize("m,rows,chunk", [
    (10, 50, 448), (7, 20, 448), (15, 30, 448), (16, 20, 448), (1000, 3, 448),
    (1000, 384, tsd.BWD_PAIRS), (10, 384, tsd.BWD_PAIRS), (4096, 64, tsd.BWD_PAIRS),
])
def test_slots_and_fold_cover_every_pair_once_with_cluster_blocks(monkeypatch, cp, m, rows,
                                                                  chunk):
    """The index maps at the cluster chain's units of P pairs (128 up to
    H = 2048, 64 above), with rows much shorter than a cluster (7, 10, 15
    points), chunks that do not end on a cluster's edge and DPS's
    384 x 1000."""
    assert cp in (64, 128)
    _check_slots_and_fold(monkeypatch, cp, m, rows, chunk)
    assert dz_maps._dz_slots(1000) == 2 and dz_maps._dz_slots(4096) == 2
    assert dz_maps._dz_slots(7) == (cp - 2 + 7) // 7 + 1 == -(-(cp - 1) // 7) + 1
    assert dz_maps._dz_slots(16) == cp // 16 + 1


def _five_field_case(root, **extra):
    """``make_case`` with a FiLM decoder of 640 units and 5 outputs, its
    snapshots 5 seeded fields (travelling waves) of the same points."""
    root.mkdir()
    nf = {"name": "SIRENAutodecoder_film", "num_hidden_layers": 1, "out_features": 5,
          "hidden_features": 640}
    hp = make_case(root, epochs=1, NF=nf, **extra)
    rng = np.random.default_rng(5)
    coords = np.load(root / "coords.npy")
    phase = rng.uniform(0, 2 * np.pi, size=(16, 1, 5))
    k = rng.normal(size=(2, 5)) * 3
    np.save(root / "fois.npy", np.sin(coords @ k + phase).astype(np.float32))
    return hp


def test_wide_five_output_trainer_matches_jax(tmp_path):
    """One epoch of a FiLM recipe at 640 hidden units and 5 outputs, which
    the JAX trainer trains through its Pallas kernels and the port's kernels
    now take: latents, decoder and the logged losses agree with the JAX
    trainer (the fused decode on both sides; the port's plain versions on
    the CPU), at the trainers' parity tolerance."""
    jhp = _five_field_case(tmp_path / "jax")
    _five_field_case(tmp_path / "torch", device="cpu")
    jtr = JTrainer(jhp)
    ttr = TTrainer(tconfig.basic_input(str(tmp_path / "torch" / "case.yml")))
    jtr.state = jtr.init_state()
    ttr.init_state(cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.state.nf_params)))
    assert ttr.use_fused_decode and jtr.use_fused_decode
    assert ttr.model.net1[-1].out_features == 5 and ttr.model.net1[0].out_features == 640
    assert all(tsd.kernel_hidden_width(640, 2, 5, family) == 640 for family in tsd.FAMILIES)
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    _assert_same_state(jtr, ttr)
    a = [float(r["loss"]) for r in _csv_rows(ttr.hp.save_path) if r.get("loss")]
    b = [float(r["loss"]) for r in _csv_rows(jtr.hp.save_path) if r.get("loss")]
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a, b, rtol=1e-5)
