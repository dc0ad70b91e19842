"""The port's multi-device layer on the CPU (gloo): the mesh helpers, ring
attention, the U-Net's ring route, the data-parallel ``TrainLoop`` and
``CNFTrainer``, the loss-aware sampler, rank-0 checkpoints and the sharded
DPS ensemble.

The ranks are child processes of this test (``torch_parallel_worker.py``,
one launch of 2 ranks and one of 4, each rank joined with a timeout); they
import torch and the port only.  The JAX side runs here, on conftest's
virtual 8-device mesh, and so do the one-process runs of the port.

Tolerances: a sharded step sums the same float32 terms in another order
(each rank's mean, then the mean over ranks), so sharded and one-process
runs agree to the JAX package's own sharded-vs-single tolerance (rtol 1e-5,
atol 1e-6, ``tests/test_multidevice.py:64-69``; the CNF epochs' 1e-4 of
``:158-163``); ring attention against JAX's and against dense attention:
rtol / atol 1e-5, float32 products in another order.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from confild_tpu.diffusion import create_gaussian_diffusion as j_create_diffusion
from confild_tpu.models import unet as junet
from confild_tpu.ops.ring_attention import ring_attention as j_ring_attention
from confild_tpu.parallel import mesh as jmesh
from confild_tpu.train.diffusion_trainer import TrainLoop as JTrainLoop
from confild_tpu.utils import logger as jlog
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.cli import sample_conditional
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.diffusion.resample import LossSecondMomentResampler
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
from confild_tpu_torch.train.diffusion_trainer import TrainLoop
from confild_tpu_torch.utils import logger as tlog
from test_cnf_trainer import make_case
from test_torch_cli import _write_assets
from test_torch_diffusion_train import _jax_draws, _state_dict
from torch_parity_utils import limit_torch_threads

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
JOIN_TIMEOUT_S = 300
TASKS = {2: ("mesh", "ring", "unet_ring", "train", "sampler", "cnf", "dps"),
         4: ("mesh", "ring", "cnf_hybrid")}
UNET = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="8", num_heads=2)
RING_SHAPE = (3, 32, 8)        # (BH, N, D)
TOL = dict(rtol=1e-5, atol=1e-6)
CNF_TOL = dict(rtol=1e-4, atol=1e-6)
RING_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ring_inputs():
    rng = np.random.default_rng(5)
    return rng.standard_normal((4, *RING_SHAPE)).astype(np.float32)


def _unet_ring_inputs():
    model = tunet.create_model(**UNET).reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():      # no zeroed layer: every gradient counts
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return {"config": UNET, "state_dict": model.state_dict(), "ring_min_tokens": 16,
            "x": torch.randn((2, 1, 16, 16), generator=gen),
            "t": torch.tensor([3, 17]), "g": torch.randn((2, 1, 16, 16), generator=gen)}


def _train_inputs(tmp):
    """The JAX loop's initial U-Net, a global batch of 8 and the JAX step's
    own draws from key 3."""
    jlog.configure(str(tmp / "jlogs"), [])
    jloop = JTrainLoop(model=junet.create_model(**UNET),
                       diffusion=j_create_diffusion(steps=20, noise_schedule="cosine"),
                       data=None, batch_size=8, lr=1e-3, ema_rate="0.9",
                       save_dir=str(tmp / "j"))
    model = tunet.create_model(**UNET)
    batch = np.random.default_rng(0).standard_normal((8, 1, 16, 16)).astype(np.float32)
    key = jax.random.key(3)
    rng = np.random.default_rng(7)
    return jloop, key, {
        "config": UNET, "state_dict": _state_dict(jloop.state.params, model),
        "batch": torch.from_numpy(batch), "draws": _jax_draws(key, batch.shape, jloop.sampler),
        "loop": {"lr": 1e-3, "ema_rate": "0.9"},
        "sampler_t": [torch.from_numpy(rng.integers(0, 20, 8)) for _ in range(3)]}


def _launch(d, world):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(d), ",".join(TASKS[world])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, deadline):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank did not finish in {JOIN_TIMEOUT_S} s:\n"
                        f"{p.communicate()[0][-4000:]}")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} OK" in out, f"rank {r}:\n{out[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches, their inputs, and the one-process runs beside them."""
    tmp = tmp_path_factory.mktemp("parallel")
    dirs = {w: tmp / f"world{w}" for w in TASKS}
    jloop, key, train = _train_inputs(tmp)
    unet_ring = _unet_ring_inputs()
    dps = _write_assets(tmp, "pt")
    for w, d in dirs.items():
        d.mkdir()
        np.save(d / "ring.npy", _ring_inputs())
        torch.save(train, d / "train.pt")
        torch.save(unet_ring, d / "unet_ring.pt")
        (d / "cnf").mkdir()
        make_case(d / "cnf", epochs=3, device="cpu", latent_noise_std=0.05)
        (d / "dps.yml").write_text(yaml.safe_dump({**dps, "save_path": str(d / "dps.npy")}))
    procs = {w: _launch(d, w) for w, d in dirs.items()}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for w in TASKS:
        _join(procs[w], deadline)

    def load(w, task):
        return [torch.load(dirs[w] / f"{task}_rank{r}.pt", weights_only=False)
                for r in range(w)]
    return {"load": load, "dirs": dirs, "tmp": tmp, "jloop": jloop, "key": key,
            "train": train, "unet_ring": unet_ring, "dps": dps}


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_layout_matches_jax(runs, world):
    """Each rank's slice is the shard JAX puts on the device of the same
    position; replicate broadcasts rank 0's value; gathers come back in
    mesh order."""
    x = jnp.arange(16 * 3, dtype=jnp.float32).reshape(16, 3)
    jshards = jmesh.shard_batch(x, jmesh.get_mesh(world))
    want = [np.asarray(s.data) for s in sorted(jshards.addressable_shards,
                                               key=lambda s: s.index[0].start)]
    for r, res in enumerate(runs["load"](world, "mesh")):
        np.testing.assert_array_equal(res["shard"].numpy(), want[r])
        np.testing.assert_array_equal(res["shard_axis1"], want[r].T)
        np.testing.assert_array_equal(res["replicated"].numpy(), np.ones(3))
        np.testing.assert_array_equal(res["gathered"].numpy(), np.arange(world))
        assert res["shape"] == {"data": world} and res["spec"] == "data"
        assert "device mesh" in res["too_many"]


def test_hybrid_grid(runs):
    """A (2, 2) (replica, data) grid: the batch shards over both axes
    jointly, in JAX's device order on its (2, 2) hybrid mesh; an uneven
    fold raises."""
    x = jnp.arange(16 * 3, dtype=jnp.float32).reshape(16, 3)
    jhyb = jmesh.get_hybrid_mesh(n_slices=2, devices=jax.devices()[:4])
    shards = {tuple(d.id for d in jhyb.devices.flat).index(s.device.id): np.asarray(s.data)
              for s in jmesh.shard_batch(x, jhyb).addressable_shards}
    for r, res in enumerate(runs["load"](4, "mesh")):
        assert res["hybrid_names"] == ("replica", "data") and res["hybrid_shape"] == (2, 2)
        assert res["hybrid_axes"] == ("replica", "data")
        assert res["hybrid_spec"] == jmesh.batch_spec(jhyb)[0]
        np.testing.assert_array_equal(res["hybrid_shard"].numpy(), shards[r])
        assert "fold" in res["uneven"]


def test_mesh_errors_without_group_or_data_axis():
    """``batch_spec`` raises without a data axis, as the JAX package's;
    ``get_mesh`` raises without a process group."""
    no_data = pmesh.DataMesh(np.arange(4).reshape(2, 2), ("model", "tensor"))
    with pytest.raises(ValueError, match="no data-parallel axis"):
        pmesh.batch_spec(no_data)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pmesh.get_mesh(2)
    assert pmesh.pad_to_multiple(10, 4) == jmesh.pad_to_multiple(10, 4) == 12


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def _dense(q, k, v, g):
    """Dense attention and its gradients (autograd, float64)."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v))
    out = torch.softmax(q @ k.transpose(1, 2) / q.shape[-1] ** 0.5, -1) @ v
    (out * torch.from_numpy(g).double()).sum().backward()
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_jax_and_dense(runs, world):
    """Forward and gradients on every rank against JAX's ring_attention
    (``jax.grad``) on a mesh of as many devices, and against dense
    attention: dK and dV are right only if each shard's gradient came home
    from its trip round the ring."""
    q, k, v, g = _ring_inputs()
    jm = jmesh.get_mesh(world)

    def loss(q, k, v):
        return jnp.sum(j_ring_attention(q, k, v, jm) * g)
    j_out = np.asarray(j_ring_attention(q, k, v, jm))
    j_grads = [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    dense = _dense(q, k, v, g)
    for r, res in enumerate(runs["load"](world, "ring")):
        got = [res[n].numpy() for n in ("out", "dq", "dk", "dv")]
        for name, a, want, d in zip(("out", "dq", "dk", "dv"), got, [j_out, *j_grads], dense):
            np.testing.assert_allclose(a, want, err_msg=f"rank {r} {name} vs JAX", **RING_TOL)
            np.testing.assert_allclose(a, d, err_msg=f"rank {r} {name} vs dense", **RING_TOL)


def test_unet_ring_route_matches_dense(runs):
    """The U-Net over a 2-rank seq_mesh with ring_min_tokens 16 routes its
    64-token attention block through the ring: output and every parameter
    gradient against the same model's dense route."""
    inp = runs["unet_ring"]
    model = tunet.create_model(**UNET)
    model.load_state_dict(inp["state_dict"])
    assert not any(getattr(m, "seq_mesh", None) for m in model.modules())
    out = model(inp["x"], inp["t"])
    (out * inp["g"]).sum().backward()
    for r, res in enumerate(runs["load"](2, "unet_ring")):
        np.testing.assert_allclose(res["out"].numpy(), out.detach().numpy(), **RING_TOL)
        # each gradient within 1e-5 of its norm, plus 1e-6 of the largest
        # gradient's norm for those that are zero up to rounding (a
        # ResBlock's input-convolution bias under a per-channel GroupNorm)
        largest = max(float(p.grad.norm()) for p in model.parameters())
        for n, p in model.named_parameters():
            err = float((res["grads"][n] - p.grad).norm())
            assert err <= RING_TOL["rtol"] * float(p.grad.norm()) + 1e-6 * largest, (r, n)


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------

def _one_process_loop(runs, sub, **kw):
    train = runs["train"]
    tlog.configure(str(runs["tmp"] / "tlogs"), [])
    model = tunet.create_model(**UNET)
    model.load_state_dict(train["state_dict"])
    return TrainLoop(model=model, diffusion=create_gaussian_diffusion(
        steps=20, noise_schedule="cosine"), data=None, batch_size=8,
        save_dir=str(runs["tmp"] / sub), device="cpu", **train["loop"], **kw)


@pytest.mark.parametrize("microbatch", [-1, 4])
def test_train_step_two_ranks_matches_one_process(runs, microbatch):
    """A step at 2 ranks (4 rows each; with microbatch 4, two of 2 rows
    under DDP's ``no_sync`` first) against one process on the same global
    batch and draws: loss and metrics, every gradient, the parameters and
    the EMA after the step, the validation MSE."""
    train = runs["train"]
    loop = _one_process_loop(runs, f"one_{microbatch}", microbatch=microbatch)
    want = loop.train_step(train["batch"], *train["draws"])
    want["valid_mse"] = loop.valid_step(train["batch"], *train["draws"])
    ranks = [res["full" if microbatch == -1 else "micro"] for res in runs["load"](2, "train")]
    for r, res in enumerate(ranks):
        got = {**res["metrics"], "valid_mse": res["valid_mse"]}
        for k, v in want.items():
            if np.isnan(v):
                assert np.isnan(got[k]), k
            else:
                np.testing.assert_allclose(got[k], v, err_msg=f"rank {r} {k}", **TOL)
        for n, p in loop.model.named_parameters():
            assert _rel_l2(res["grads"][n], p.grad) <= TOL["rtol"], (r, n)
        for k, v in loop.model.state_dict().items():
            np.testing.assert_allclose(res["params"][k], v, err_msg=f"rank {r} {k}", **TOL)
        for k, v in loop.ema_state_dict(0).items():
            np.testing.assert_allclose(res["ema"][k], v, err_msg=f"rank {r} ema {k}", **TOL)
    for k, v in ranks[0]["params"].items():      # replicated: the same on both ranks
        assert torch.equal(v, ranks[1]["params"][k]), k


def test_train_step_two_ranks_matches_jax_sharded(runs):
    """The same step against the JAX loop's ``_train_step`` with the batch
    sharded over 2 devices, from the same key: loss and parameters."""
    jloop, key = runs["jloop"], runs["key"]
    jm = jmesh.get_mesh(2)
    jlog.configure(str(runs["tmp"] / "jlogs2"), [])
    jsharded = JTrainLoop(model=jloop.model, diffusion=jloop.diffusion, data=None,
                          batch_size=8, lr=1e-3, ema_rate="0.9",
                          save_dir=str(runs["tmp"] / "j2"), mesh=jm)
    state, metrics = jsharded._train_step(
        jsharded.state, jmesh.shard_batch(jnp.asarray(runs["train"]["batch"].numpy()), jm), key)
    want = _state_dict(state.params, tunet.create_model(**UNET))
    for r, res in enumerate(runs["load"](2, "train")):
        np.testing.assert_allclose(res["full"]["metrics"]["loss"], float(metrics["loss"]),
                                   rtol=TOL["rtol"])
        for k, v in want.items():
            np.testing.assert_allclose(res["full"]["params"][k], v, err_msg=f"rank {r} {k}",
                                       **TOL)


def test_loss_aware_sampler_state_is_global(runs):
    """LossSecondMomentResampler fed the gathered losses: the same state
    on both ranks, bitwise, and the one-process state."""
    train = runs["train"]
    loop = _one_process_loop(runs, "sampler", schedule_sampler=LossSecondMomentResampler(20, 2))
    for t in train["sampler_t"]:
        loop.train_step(train["batch"], t, torch.ones(8), train["draws"][2])
    a, b = runs["load"](2, "sampler")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["counts"], loop.sampler_state["counts"])
    np.testing.assert_allclose(a["history"], loop.sampler_state["history"], **TOL)


def test_rank0_checkpoints(runs):
    """Rank 0 writes the triplet and every rank reads back its own state;
    rotation to one generation is rank 0's: another rank deletes nothing."""
    for r, res in enumerate(runs["load"](2, "train")):
        assert res["read_back"], r
        assert res["files"] == ["ema_0.9_000002.pt", "model000002.pt", "opt000002.pt"]
        assert res["rotated"] == ([] if r else [str(runs["dirs"][2] / "rotate" /
                                                     "model000001.pt")])
        assert res["rotate_left"] == ["model000002.pt"]


def _one_process_cnf(runs, w):
    d = runs["dirs"][w] / "cnf"
    hp = tconfig.basic_input(str(d / "case.yml"), save_path=str(d / "run_one"))
    tr = CNFTrainer(hp, device="cpu")
    tr.init_state(seed=0)
    tr.train(log_formats=())
    return tr


@pytest.mark.parametrize("world,task", [(2, "cnf"), (4, "cnf_hybrid")])
def test_cnf_epochs_match_one_process(runs, world, task):
    """Three epochs with latent noise (the decoder stepping at epochs 1 and
    2) at 2 ranks and on a 2 x 2 (replica, data) grid against one
    process: latents, decoder, the unapplied gradient sum, the rMAE; rank 0
    alone wrote the checkpoints."""
    tr = _one_process_cnf(runs, world)
    accum = {n: p.grad for n, p in tr.model.named_parameters()}
    for r, res in enumerate(runs["load"](world, task)):
        np.testing.assert_allclose(res["latents"], tr.state.latents.detach(), **CNF_TOL)
        for k, v in tr.model.state_dict().items():
            np.testing.assert_allclose(res["params"][k], v, err_msg=f"rank {r} {k}", **CNF_TOL)
        for k, v in accum.items():
            assert _rel_l2(res["accum"][k], v) <= CNF_TOL["rtol"], (r, k)
        np.testing.assert_allclose(res["rmae"], tr.eval_rmae(), **CNF_TOL)
        assert [f for f in res["files"] if f.endswith(".pt")] == sorted(
            f for f in os.listdir(tr.hp.save_path) if f.endswith(".pt"))


def test_dps_ensemble_two_ranks_matches_one_process(runs):
    """``cli.sample_conditional`` with a 2-member ensemble over 2 ranks (one
    member each): rank 0's saved fields against one process's."""
    d = runs["dirs"][2]
    a, b = runs["load"](2, "dps")
    assert a["decode_s"] is not None and b["decode_s"] is None
    assert a["steps"] == b["steps"] == 4
    one = runs["tmp"] / "dps_one.yml"
    one.write_text(yaml.safe_dump({**runs["dps"], "save_path": str(runs["tmp"] / "one.npy")}))
    sample_conditional.main([str(one)])
    want = np.load(runs["tmp"] / "one.npy")
    got = np.load(d / "dps.npy")
    assert got.shape == want.shape == (2, 8, 60, 1)
    np.testing.assert_allclose(got, want, **TOL)
