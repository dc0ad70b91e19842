"""Port vs JAX package for diffusion training on the CPU: ``training_losses``
(plain MSE, the learned-sigma ``vb`` term with its stop-gradient, the KL
loss), both timestep resamplers, the ``TrainLoop`` step by step on
``tests/test_diffusion_trainer.py``'s tiny model with the JAX step's own
draws fed to the port, resume from the port's ``.pt`` triplet and from a
JAX ``.ckpt`` triplet with JAX and optax blocked, and the training CLI end
to end."""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from confild_tpu.diffusion import create_gaussian_diffusion as j_create_diffusion
from confild_tpu.diffusion import resample as jresample
from confild_tpu.models import unet as junet
from confild_tpu.train.diffusion_trainer import TrainLoop as JTrainLoop
from confild_tpu.train.diffusion_trainer import load_latent_image_data as j_load_data
from confild_tpu.utils import logger as jlog
from confild_tpu_torch import config
from confild_tpu_torch.cli import sample_conditional, train_diffusion
from confild_tpu_torch.diffusion import create_gaussian_diffusion as t_create_diffusion
from confild_tpu_torch.diffusion import resample as tresample
from confild_tpu_torch.io import checkpoint as tckpt
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.train.diffusion_trainer import TrainLoop, load_latent_image_data
from torch_parity_utils import limit_torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="8", num_heads=2)
# f32 both sides; convolutions and GroupNorm sum in other orders
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# Adam divides each gradient by its own scale, so an element whose gradient
# is near 0 (within the f32 summation error) may step by up to lr either
# way: after three steps at lr 1e-3, 1 element in 18432 of one tensor sat
# 1e-4 apart.  So all but 0.1% of the elements must agree to STATE_TOL, and
# every element to within 2 lr a step
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


# ---------------------------------------------------------------------------
# training_losses
# ---------------------------------------------------------------------------

def _toy_models(learn_sigma: bool):
    """The same small differentiable "model" in both frameworks: a
    per-timestep affine map of x, doubled in channels for a learned sigma."""
    def jmodel(a, x, t):
        out = a[0] * x + a[1] * jnp.tanh(x) + 1e-3 * t.astype(jnp.float32)[:, None, None, None]
        return jnp.concatenate([out, jnp.tanh(a[2] * x)], axis=1) if learn_sigma else out

    def tmodel(a, x, t):
        out = a[0] * x + a[1] * torch.tanh(x) + 1e-3 * t.float()[:, None, None, None]
        return torch.cat([out, torch.tanh(a[2] * x)], dim=1) if learn_sigma else out
    return jmodel, tmodel


@pytest.mark.parametrize("kw", [
    dict(),
    dict(learn_sigma=True),
    dict(learn_sigma=True, rescale_learned_sigmas=True),
    dict(use_kl=True),
    dict(use_kl=True, learn_sigma=True),
    dict(predict_xstart=True, timestep_respacing="10"),
])
@pytest.mark.parametrize("valid", [False, True])
def test_training_losses_match_jax(kw, valid):
    """Every term and the gradient of the weighted loss with respect to the
    model's parameters (so the ``vb`` term's stop-gradient on the mean half
    is held too)."""
    jd = j_create_diffusion(steps=40, noise_schedule="cosine", **kw)
    td = t_create_diffusion(steps=40, noise_schedule="cosine", **kw)
    rng = np.random.default_rng(0)
    x0 = np.clip(rng.standard_normal((6, 1, 8, 8)), -1, 1).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 1, 5, 17, 38, 39]) * jd.num_timesteps // 40
    a = np.array([0.7, 0.2, 0.5], np.float32)
    jmodel, tmodel = _toy_models(kw.get("learn_sigma", False))

    def jloss(a):
        terms = jd.training_losses(lambda x, tt: jmodel(a, x, tt), jnp.asarray(x0),
                                   jnp.asarray(t), None, noise=jnp.asarray(noise), valid=valid)
        return terms["loss"].mean(), terms
    (_, jterms), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(a))

    ta = torch.tensor(a, requires_grad=True)
    tterms = td.training_losses(lambda x, tt: tmodel(ta, x, tt), torch.from_numpy(x0),
                                torch.from_numpy(t), noise=torch.from_numpy(noise), valid=valid)
    tterms["loss"].mean().backward()
    assert set(tterms) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(tterms[k].detach().numpy(), np.asarray(jterms[k]),
                                   err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# resamplers
# ---------------------------------------------------------------------------

def test_uniform_sampler():
    s = tresample.create_named_schedule_sampler("uniform", 50)
    t, w, st = s.sample(s.init_state(), torch.Generator().manual_seed(0), 64)
    assert t.dtype == torch.int64 and t.shape == (64,) and 0 <= int(t.min()) <= int(t.max()) < 50
    assert torch.equal(w, torch.ones(64)) and s.update(st, t, w) == ()
    with pytest.raises(NotImplementedError):
        tresample.create_named_schedule_sampler("nope", 50)


def test_loss_second_moment_resampler_matches_jax():
    """Same (t, loss) updates into both: history, counts and the sampling
    weights match, uniform before warm-up and importance after; a drawn
    batch's weights are ``1 / (T p[t])``."""
    T, H = 6, 3
    js = jresample.LossSecondMomentResampler(T, history_per_term=H)
    ts = tresample.LossSecondMomentResampler(T, history_per_term=H)
    jstate, tstate = js.init_state(), ts.init_state()
    rng = np.random.default_rng(1)
    for step in range(12):
        t = rng.integers(0, T, size=5) if step < 10 else np.arange(T)
        losses = rng.uniform(0.1, 2.0, size=t.shape).astype(np.float32)
        jstate = js.update(jstate, jnp.asarray(t), jnp.asarray(losses))
        tstate = ts.update(tstate, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(tstate["counts"].numpy(), np.asarray(jstate["counts"]))
        np.testing.assert_allclose(tstate["history"].numpy(), np.asarray(jstate["history"]),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(ts.weights(tstate).numpy(), np.asarray(js._weights(jstate)),
                                   rtol=1e-6)
    assert bool((tstate["counts"] == H).all())
    p = ts.weights(tstate)
    assert not torch.allclose(p, torch.full((T,), 1.0 / T))
    t, w, _ = ts.sample(tstate, torch.Generator().manual_seed(2), 32)
    torch.testing.assert_close(w, 1.0 / (T * p[t]))


# ---------------------------------------------------------------------------
# the trainer, step by step against the JAX TrainLoop
# ---------------------------------------------------------------------------

def _data(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "train.npy", rng.normal(size=(32, 16, 16)).astype(np.float32))
    np.save(tmp_path / "valid.npy", rng.normal(size=(8, 16, 16)).astype(np.float32))
    return str(tmp_path / "train.npy"), str(tmp_path / "valid.npy")


def _jax_draws(key, shape, sampler):
    """What the JAX step draws from ``key`` (``diffusion_trainer.py:
    200-206`` for a training step, ``:329-338`` for a validation step)."""
    t_key, noise_key = jax.random.split(key)
    t, weights, _ = sampler.sample(sampler.init_state(), t_key, shape[0])
    noise = jax.random.normal(noise_key, shape, jnp.float32)
    return (torch.from_numpy(np.asarray(t, np.int64)), torch.from_numpy(np.array(weights)),
            torch.from_numpy(np.array(noise)))


def _state_dict(params, model):
    return unet_state_dict_from_jax(jax.tree.map(np.asarray, params), model)


def _assert_close_state(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), err_msg=k, **tol)


def _assert_close_trained(got: dict, want: dict, lr: float, steps: int):
    """Trained states, under the Adam allowance of ``STATE_TOL``."""
    assert set(got) == set(want)
    far, total = 0, 0
    for k, v in want.items():
        a, b = got[k].detach().numpy(), v.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * steps, err_msg=k)
        far += int(np.sum(np.abs(a - b) > STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(b)))
        total += b.size
    assert far <= ADAM_FLIP_SHARE * total, (far, total)


def _loops(tmp_path, microbatch, **kw):
    train, valid = _data(tmp_path)
    jlog.configure(str(tmp_path / "jlogs"), [])
    jdata, jvalid, _ = j_load_data(train, valid, batch_size=8)
    jloop = JTrainLoop(model=junet.create_model(**UNET),
                       diffusion=j_create_diffusion(steps=20, noise_schedule="cosine"),
                       data=jdata, valid_data=jvalid, batch_size=8, microbatch=microbatch,
                       save_dir=str(tmp_path / "j"), **kw)
    tm = tunet.create_model(**UNET)
    tm.load_state_dict(_state_dict(jloop.state.params, tm))
    tloop = TrainLoop(model=tm, diffusion=t_create_diffusion(steps=20, noise_schedule="cosine"),
                      data=None, batch_size=8, microbatch=microbatch,
                      save_dir=str(tmp_path / "t"), device="cpu", **kw)
    return jloop, tloop, load_latent_image_data(train, valid, batch_size=8)


@pytest.mark.parametrize("microbatch", [-1, 4])
def test_train_steps_match_jax(tmp_path, microbatch):
    """Three steps of the JAX loop (``run_step``) and of the port's
    ``train_step`` / ``valid_step`` on the same batches and the JAX step's
    own draws: losses, validation MSE, norms, parameters and both EMAs."""
    jloop, tloop, (tdata, tvalid, _) = _loops(
        tmp_path, microbatch, lr=1e-3, ema_rate="0.5,0.9", lr_anneal_steps=5,
        weight_decay=1e-2)
    logger = jlog.get_current()
    for _ in range(3):
        _, step_key, valid_key = jax.random.split(jloop.key, 3)
        batch, _ = next(tdata)
        vbatch, _ = next(tvalid)
        jloop.run_step(batch)
        want = logger.dumpkvs()
        got = tloop.train_step(torch.from_numpy(batch),
                               *_jax_draws(step_key, batch.shape, jloop.sampler))
        got["valid_mse"] = tloop.valid_step(torch.from_numpy(vbatch),
                                            *_jax_draws(valid_key, vbatch.shape, jloop.sampler))
        for k in ("loss", "mse", "valid_mse", "grad_norm", "param_norm", "loss_q0",
                  "loss_q1", "loss_q2", "loss_q3", "skipped_nonfinite"):
            if np.isnan(got[k]):
                assert k not in want, k       # an empty quartile is not logged
            else:
                np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=1e-4, atol=1e-6)
    assert tloop.step == int(jloop.state.step) == 3
    _assert_close_trained(tloop.model.state_dict(),
                          _state_dict(jloop.state.params, tloop.model), lr=1e-3, steps=3)
    for i, ema in enumerate(jloop.state.ema_params):
        _assert_close_trained(tloop.ema_state_dict(i), _state_dict(ema, tloop.model),
                              lr=1e-3, steps=3)


def test_nonfinite_gradient_skips_the_update(tmp_path):
    """A batch with a NaN gives a non-finite gradient: parameters and AdamW
    state stay as they were, the EMA still moves toward the parameters and
    ``skipped_nonfinite`` is 1 (``diffusion_trainer.py:239-248``)."""
    _, loop, (data, _, _) = _loops(tmp_path, -1, lr=1e-3, ema_rate="0.5")
    batch = torch.from_numpy(next(data)[0])
    draws = (torch.arange(8) % 20, torch.ones(8), torch.zeros_like(batch))
    loop.train_step(batch, *draws)
    before = {k: v.clone() for k, v in loop.model.state_dict().items()}
    opt_before = {k: v.clone() for k, v in loop.opt.state[loop.params[0]].items()}
    ema_before = [e.clone() for e in loop.ema_params[0]]
    bad = batch.clone()
    bad[0, 0, 0, 0] = float("nan")
    m = loop.train_step(bad, *draws)
    assert m["skipped_nonfinite"] == 1.0 and not np.isfinite(m["grad_norm"])
    for k, v in loop.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in loop.opt.state[loop.params[0]].items():
        assert torch.equal(v, opt_before[k]), k
    for e, e0, p in zip(loop.ema_params[0], ema_before, loop.params):
        torch.testing.assert_close(e, 0.5 * e0 + 0.5 * p.detach())
    assert loop.step == 2


def test_unported_options_raise(tmp_path):
    model, diff = tunet.create_model(**UNET), t_create_diffusion(steps=20, noise_schedule="cosine")
    # steps_per_call and device_data are ported (tests/test_torch_multistep.py),
    # and mesh (tests/test_torch_parallel.py): a mesh that is not a DataMesh
    # is refused
    for kw in (dict(mesh=object()),):
        with pytest.raises(TypeError, match="DataMesh"):
            TrainLoop(model=model, diffusion=diff, data=None, batch_size=4, device="cpu",
                      save_dir=str(tmp_path), **kw)


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

def test_resume_from_pt_triplet_continues_bitwise(tmp_path):
    """The port's triplet carries everything a step needs: a loop resumed
    from ``model000003.pt`` takes the same fourth step as the loop that
    wrote it.  Rotation keeps whole triplets."""
    _, a, (data, _, _) = _loops(tmp_path, -1, lr=1e-3, ema_rate="0.5,0.9", lr_anneal_steps=6,
                                keep_checkpoints=2)
    batches = [torch.from_numpy(next(data)[0]) for _ in range(4)]
    g = torch.Generator().manual_seed(0)
    draws = [(torch.randint(0, 20, (8,), generator=g), torch.ones(8),
              torch.randn(b.shape, generator=g)) for b in batches]
    for i in range(3):
        a.train_step(batches[i], *draws[i])
        a.save()
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(f"{p}{s:06d}.pt" for s in (2, 3)
                           for p in ("model", "opt", "ema_0.5_", "ema_0.9_"))
    b = TrainLoop(model=tunet.create_model(**UNET), diffusion=a.diffusion, data=None,
                  batch_size=8, lr=1e-3, ema_rate="0.5,0.9", lr_anneal_steps=6,
                  resume_checkpoint=str(tmp_path / "t" / "model000003.pt"), device="cpu",
                  save_dir=str(tmp_path / "t"))
    assert b.resume_step == b.step == 3 and b._update_count() == 3
    for loop in (a, b):
        loop.train_step(batches[3], *draws[3])
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    for ea, eb in zip(a.ema_params, b.ema_params):
        assert all(torch.equal(x, y) for x, y in zip(ea, eb))
    assert tckpt.find_ema_checkpoint(str(tmp_path / "t" / "model000003.pt"), 3, "0.9") == \
        str(tmp_path / "t" / "ema_0.9_000003.pt")
    assert tckpt.find_ema_checkpoint(None, 3, "0.9") is None


RESUME_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["optax"] = None
import torch
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.models import unet
from confild_tpu_torch.train.diffusion_trainer import TrainLoop
loop = TrainLoop(model=unet.create_model(**eval(sys.argv[2])),
                 diffusion=create_gaussian_diffusion(steps=20, noise_schedule="cosine"),
                 data=None, batch_size=8, lr=1e-3, ema_rate="0.5", lr_anneal_steps=5,
                 resume_checkpoint=sys.argv[1], device="cpu", save_dir=sys.argv[3])
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "optax")
             and sys.modules[k] is not None)
assert not bad, bad
names = [n for n, _ in loop.model.named_parameters()]
torch.save({"step": loop.step, "model": loop.model.state_dict(), "ema": loop.ema_state_dict(0),
            "opt": {n: dict(loop.opt.state[p]) for n, p in zip(names, loop.params)}},
           sys.argv[4])
"""


def test_resume_from_jax_ckpt_without_jax(tmp_path):
    """The JAX loop writes a real ``.ckpt`` triplet (optax AdamW state
    pickled); a process where importing jax or optax fails resumes the
    port's loop from it: parameters, EMA and the AdamW moments and count."""
    jloop, _, (data, _, _) = _loops(tmp_path, -1, lr=1e-3, ema_rate="0.5", lr_anneal_steps=5)
    for _ in range(2):
        jloop.run_step(next(data)[0])
    jloop.save()
    ckpt = str(tmp_path / "j" / "model000002.ckpt")
    with open(tmp_path / "j" / "opt000002.ckpt", "rb") as f:
        assert b"optax" in f.read()
    out = tmp_path / "resumed.pt"
    proc = subprocess.run(
        [sys.executable, "-c", RESUME_WITHOUT_JAX, ckpt, repr(UNET), str(tmp_path / "r"),
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(out, weights_only=True)
    assert got["step"] == 2
    tm = tunet.create_model(**UNET)
    s = jloop.state
    _assert_close_state(got["model"], _state_dict(s.params, tm), rtol=0, atol=0)
    _assert_close_state(got["ema"], _state_dict(s.ema_params[0], tm), rtol=0, atol=0)
    adam = s.opt_state[0]
    mu, nu = _state_dict(adam.mu, tm), _state_dict(adam.nu, tm)
    for k, st in got["opt"].items():
        assert float(st["step"]) == float(adam.count) == 2.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[k].numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _recipe(tmp_path, **over):
    train, valid = _data(tmp_path)
    r = dict(UNET, num_head_channels=-1, batch_size=8, steps=20, noise_schedule="cosine",
             microbatch=4, lr=1e-4, ema_rate="0.9999", log_interval=1, save_interval=2,
             lr_anneal_steps=3, log_path=str(tmp_path / "logs"), train_data_path=train,
             valid_data_path=valid, use_flash_attention=True, device="cpu")
    r.update(over)
    path = tmp_path / "case.yml"
    path.write_text(yaml.safe_dump(r))
    return str(path)


def test_train_diffusion_cli_cpu(tmp_path, monkeypatch):
    """The CLI on the CPU with flash attention on: three steps with the
    published progress columns, the triplets at steps 2 and 3, a resume that
    continues to step 4 from the saved EMA, and the EMA file read by the
    sampling CLI's loader."""
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "")
    loop = train_diffusion.main([_recipe(tmp_path)])
    logs = tmp_path / "logs"
    assert loop.step == 3
    with open(logs / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2, 3]
    assert {"loss", "mse", "valid_mse", "grad_norm", "param_norm",
            "skipped_nonfinite"} <= set(rows[0])
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    for name in ("model000002.pt", "ema_0.9999_000002.pt", "opt000003.pt", "data_max.npy"):
        assert (logs / name).exists(), name
    ema3 = torch.load(logs / "ema_0.9999_000003.pt", weights_only=True)

    again = train_diffusion.main([_recipe(
        tmp_path, lr_anneal_steps=4, resume_checkpoint=str(logs / "model000003.pt"))])
    assert again.resume_step == 3 and again.step == 4
    params4 = torch.load(logs / "model000004.pt", weights_only=True)
    for k, v in torch.load(logs / "ema_0.9999_000004.pt", weights_only=True).items():
        torch.testing.assert_close(v, 0.9999 * ema3[k] + 0.0001 * params4[k])

    model, _ = sample_conditional.build_model_and_diffusion(
        config.basic_input(str(tmp_path / "case.yml")))
    sample_conditional.load_unet(str(logs / "ema_0.9999_000004.pt"), model)
    assert all(s.use_flash for s in model.plan.middle_block if isinstance(s, tunet.AttnSpec))


def test_train_diffusion_cli_refusals(tmp_path, monkeypatch):
    """bf16, which raised, trains now: a ``use_bf16`` recipe with block
    rematerialization takes its steps with finite losses on float32
    parameters; without a card and without ``device: cpu`` the CLI raises;
    ``DIFFUSION_TRAINING_TEST`` stops at the first save."""
    loop = train_diffusion.main([_recipe(tmp_path, use_bf16=True, use_checkpoint=True,
                                         remat_policy="matmuls", lr_anneal_steps=2,
                                         log_path=str(tmp_path / "bf16"))])
    assert loop.step == 2 and loop.model.cfg.torso_dtype == torch.bfloat16
    assert loop.model.cfg.use_checkpoint and loop.model.cfg.remat_policy == "matmuls"
    assert all(p.dtype == torch.float32 for p in loop.model.parameters())
    with open(tmp_path / "bf16" / "progress.csv") as f:
        assert all(np.isfinite(float(r["loss"])) for r in csv.DictReader(f))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_diffusion.main([_recipe(tmp_path, device=None)])
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    loop = train_diffusion.main([_recipe(tmp_path, lr_anneal_steps=6, microbatch=-1,
                                         use_flash_attention=None)])
    assert loop.step == 2
