"""The SIREN-FiLM kernels at more than 16 coordinates or outputs, on the CPU.

The JAX package's three SIREN kernels block on the whole feature axis and
take any number of input and output features; the port's kernels keep
tables of ``FEATURE_CHUNK`` (16) features a pair and take wider ones in
chunks of it (``csrc/siren_fwd_cluster.cu``, ``siren_chain_cluster.cu``,
``siren_decode_bwd.cu``), so their plans do not depend on the features.
Here, at ``C_in -> C_out`` of 17 -> 3, 3 -> 17, 20 -> 24 and 40 -> 64 on a
small decoder (3 modulated layers of 32, 16 latents, 5 rows x 300
points), the port's fused decode (on the CPU, the kernels' plain
versions) against the JAX package's Pallas kernels in interpret mode, the
weights carried across by ``cnf_state_dict_from_jax``, the inputs from a
numpy seed: the float32 forward (rtol 1e-5, ``test_torch_siren_fwd.py``'s),
the bf16 ``compute_dtype`` forward (relative L2 1e-3,
``test_torch_bf16.py``'s), dz and every cotangent of the training backward
(rtol 1e-4, ``test_torch_siren_dz.py``'s and ``test_torch_siren_wide.py``'s);
the plans and the sums kernel's jobs against the features; and one epoch of
the port's trainer against the JAX trainer at 17 outputs.  The kernels
themselves run on the card (``chip_smoke.py`` phase 20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


FEATURES = [(17, 3), (3, 17), (20, 24), (40, 64)]
ROWS, POINTS, LATENT = 5, 300, 16
# test_torch_bf16.py's relative L2 of the bf16 forward against JAX's
DECODE_BF16_TOL = 1e-3


def _case(c_in, c_out, seed):
    params, model = jax_siren(c_in=c_in, latent=LATENT, c_out=c_out, layers=2, hidden=32,
                              seed=seed)
    rng = np.random.default_rng(seed + 100 * c_in + c_out)
    coords = rng.uniform(-1, 1, (POINTS, c_in)).astype(np.float32)
    latents = (0.1 * rng.standard_normal((ROWS, LATENT))).astype(np.float32)
    g = rng.standard_normal((ROWS, POINTS, c_out)).astype(np.float32)
    return params, model, coords, latents, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("c_in,c_out", FEATURES)
def test_forward_matches_pallas_interpret(c_in, c_out):
    params, model, coords, latents, _ = _case(c_in, c_out, seed=0)
    want = np.asarray(jsd._fused_forward(params, jnp.asarray(coords), jnp.asarray(latents),
                                         30.0, 2, 128, True, jnp.float32))
    with torch.no_grad():
        got = tsd.fused_siren_decode(model, t(coords), t(latents)).numpy()
    assert got.shape == want.shape == (ROWS, POINTS, c_out)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("c_in,c_out", FEATURES)
def test_bf16_forward_matches_pallas_interpret(c_in, c_out):
    """The bf16 ``compute_dtype`` forward against JAX's bf16 kernel; the
    float32 forward is outside the tolerance."""
    params, model, coords, latents, _ = _case(c_in, c_out, seed=1)
    want = np.asarray(jsd._fused_forward(params, jnp.asarray(coords), jnp.asarray(latents),
                                         30.0, 2, 128, True, jnp.bfloat16))
    with torch.no_grad():
        got = tsd.fused_siren_decode(model, t(coords), t(latents),
                                     compute_dtype=torch.bfloat16).numpy()
        f32 = tsd.fused_siren_decode(model, t(coords), t(latents)).numpy()
    assert got.shape == want.shape == (ROWS, POINTS, c_out)
    assert _rel(got, want) <= DECODE_BF16_TOL
    assert _rel(f32, want) > DECODE_BF16_TOL


@pytest.mark.parametrize("c_in,c_out", FEATURES)
def test_dz_matches_pallas_interpret(c_in, c_out):
    params, model, coords, latents, g = _case(c_in, c_out, seed=2)
    want = np.asarray(jsd.fused_siren_decode_dz(params, coords, latents, g, 30.0, 8, 128, True))
    got = tsd.fused_siren_decode_dz(model, t(coords), t(latents), t(g)).numpy()
    assert got.shape == want.shape == (ROWS, LATENT)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c_in,c_out", FEATURES)
def test_bwd_matches_pallas_interpret(c_in, c_out):
    """Every cotangent of the training backward: the decoder's leaves
    (dW_first over C_in rows, dW_head over C_out columns) and the
    latents'."""
    params, model, coords, latents, g = _case(c_in, c_out, seed=3)
    jdp, jdl = jsd.fused_siren_decode_bwd(params, coords, latents, g, 30.0, 8, 128, True)
    grads, dlatents = tsd.fused_siren_decode_bwd(model, t(coords), t(latents), t(g))
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jdp))
    assert set(grads) == set(want)
    assert grads["net1.0.weight"].shape == (32, c_in)
    assert grads["net1.3.weight"].shape == (c_out, 32)
    for k in want:
        # f32 sums over the pairs in another order: the absolute floor is
        # 1e-6 of each leaf's largest magnitude (the kernels' criterion's)
        w = want[k].numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4,
                                   atol=max(1e-5, 1e-6 * np.abs(w).max()), err_msg=k)
    np.testing.assert_allclose(dlatents.numpy(), np.asarray(jdl), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c_in,c_out", FEATURES)
def test_train_op_gradients_match_jax(c_in, c_out):
    """The train op (``fused_siren_decode_train``, the FiLM trainer's) end
    to end through autograd against ``jax.grad`` of JAX's train op in
    interpret mode: the gradients of a loss on the decode with respect to
    the decoder and the latents."""
    params, model, coords, latents, g = _case(c_in, c_out, seed=4)

    def jloss(p, lat):
        out = jsd.fused_siren_decode_train(p, jnp.asarray(coords), lat, 30.0, 2, 128, True)
        return jnp.sum(out * jnp.asarray(g))

    jgp, jgl = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(latents))
    lat = t(latents).requires_grad_(True)
    (tsd.fused_siren_decode_train(model, t(coords), lat) * t(g)).sum().backward()
    want = cnf_state_dict_from_jax(jax.tree.map(np.asarray, jgp))
    for k, p in model.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=max(1e-5, 1e-6 * np.abs(w).max()), err_msg=k)
    np.testing.assert_allclose(lat.grad.numpy(), np.asarray(jgl), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h", [64, 128, 384, 512, 1024, 2048, 3072])
def test_plans_do_not_depend_on_the_features(h):
    """Every family runs a width at the cluster plan's width whatever the
    features (the old limit of 16 is gone), and the plan, its rings and
    its shared memory are those of the width alone: the tables hold one
    chunk of ``FEATURE_CHUNK`` features."""
    plan = tsd.cluster_plan(h)
    for family in tsd.FAMILIES:
        widths = {tsd.kernel_hidden_width(h, c_in, c_out, family)
                  for c_in in (1, 3, 16, 17, 40, 1000) for c_out in (1, 5, 16, 24, 64, 1000)}
        assert widths == {plan.width}
    assert tsd.FEATURE_CHUNK == 16
    # the float32 kernels' block: the ring of TF32-halved stages, the share,
    # two tables of P x FEATURE_CHUNK floats, row offsets, the ring's
    # barriers and release counters (csrc/siren_cluster.cuh::smem_bytes)
    p, s, ns = plan.pairs, plan.share, plan.ring()
    assert plan.shared_bytes() == (128 + ns * 16 * s * 8 + p * (s + 16) * 4 + 2 * p * 16 * 4
                                   + p * 4 + 16 * ns)
    for family in tsd.FAMILIES:
        with pytest.raises(ValueError, match="at least one input and one output"):
            tsd.kernel_hidden_width(h, 0, 3, family)


@pytest.mark.parametrize("c", [1, 15, 16, 17, 20, 24, 32, 33, 40, 64])
def test_feature_chunks_cover_the_features(c):
    """The chunks of ``FEATURE_CHUNK`` features the kernels take: in order,
    each feature once, every chunk but the last full; one chunk at C <= 16
    (the path of the kernels before chunks)."""
    chunks = tsd.feature_chunks(c)
    assert [k for c0, n in chunks for k in range(c0, c0 + n)] == list(range(c))
    assert all(n == tsd.FEATURE_CHUNK for _, n in chunks[:-1]) and 1 <= chunks[-1][1] <= 16
    assert len(chunks) == -(-c // 16) and (len(chunks) == 1) == (c <= 16)


@pytest.mark.parametrize("n_mod", [1, 2, 16])
@pytest.mark.parametrize("c_in,c_out", [(3, 5), (16, 16)] + FEATURES)
def test_sums_jobs_cover_every_cotangent_once(n_mod, c_in, c_out):
    """The sums kernel's grid (``bwd_sums_jobs``): one job a layer's dz,
    dW_first's first chunk with layer 0's, dW_head's first chunk, then one
    job each further chunk; every dz layer, every dW_first row (feature)
    and every dW_head column once, and at C <= 16 the n_mod + 1 jobs of
    the kernel before chunks."""
    jobs = tsd.bwd_sums_jobs(n_mod, c_in, c_out)
    assert len(jobs) == n_mod + len(tsd.feature_chunks(c_in)) + len(tsd.feature_chunks(c_out)) - 1
    if c_in <= 16 and c_out <= 16:
        assert len(jobs) == n_mod + 1
    dz = [l for what, l, _ in jobs if what == "dz"]
    first = [c0 for what, l, c0 in jobs if what == "first" or (what == "dz" and l == 0)]
    head = [c0 for what, _, c0 in jobs if what == "head"]
    assert dz == list(range(n_mod))
    width = dict(tsd.feature_chunks(c_in))
    assert sorted(k for c0 in first for k in range(c0, c0 + width[c0])) == list(range(c_in))
    width = dict(tsd.feature_chunks(c_out))
    assert sorted(k for c0 in head for k in range(c0, c0 + width[c0])) == list(range(c_out))


def _wide_output_case(root, c_out, **extra):
    """``make_case`` with a FiLM decoder of ``c_out`` outputs (3 modulated
    layers of 32), its snapshots ``c_out`` seeded travelling waves."""
    root.mkdir()
    nf = {"name": "SIRENAutodecoder_film", "num_hidden_layers": 2, "out_features": c_out,
          "hidden_features": 32}
    hp = make_case(root, epochs=1, NF=nf, **extra)
    rng = np.random.default_rng(c_out)
    coords = np.load(root / "coords.npy")
    phase = rng.uniform(0, 2 * np.pi, size=(16, 1, c_out))
    k = rng.normal(size=(2, c_out)) * 3
    np.save(root / "fois.npy", np.sin(coords @ k + phase).astype(np.float32))
    return hp


def test_seventeen_output_trainer_matches_jax(tmp_path):
    """One epoch of a FiLM recipe with 17 output fields, which the JAX
    trainer trains through its Pallas kernels and the port's CUDA kernels
    used to refuse: latents, decoder and the logged losses agree with the
    JAX trainer (the fused decode on both sides; the port's plain versions
    on the CPU), at the trainers' parity tolerance."""
    jhp = _wide_output_case(tmp_path / "jax", 17)
    _wide_output_case(tmp_path / "torch", 17, device="cpu")
    jtr = JTrainer(jhp)
    ttr = TTrainer(tconfig.basic_input(str(tmp_path / "torch" / "case.yml")))
    jtr.state = jtr.init_state()
    ttr.init_state(cnf_state_dict_from_jax(jax.tree.map(np.asarray, jtr.state.nf_params)))
    assert ttr.use_fused_decode and jtr.use_fused_decode
    assert ttr.model.net1[-1].out_features == 17
    assert all(tsd.kernel_hidden_width(32, 2, 17, family) == 128 for family in tsd.FAMILIES)
    jtr.train(log_formats=())
    ttr.train(log_formats=())
    _assert_same_state(jtr, ttr)
    a = [float(r["loss"]) for r in _csv_rows(ttr.hp.save_path) if r.get("loss")]
    b = [float(r["loss"]) for r in _csv_rows(jtr.hp.save_path) if r.get("loss")]
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a, b, rtol=1e-5)
