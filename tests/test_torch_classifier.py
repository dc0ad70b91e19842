"""Port vs JAX package for the classifier and super-resolution slice: the
class-conditional U-Net, ``bilinear_resize``, ``SuperResModel``,
``EncoderUNetModel`` (every pool, ``dims=3``, channels-last input) and its
attention pool, ``ClassifierTrainLoop`` step by step on the JAX loop's own
draws, ``classifier_cond_fn`` through DDPM and DDIM (the setup of
``tests/test_extras.py:170-226``), ``cli.train_classifier`` against the JAX
CLI, and two gloo ranks against one process.

The JAX weights are carried over by ``io/convert.py`` (perturbed, so that
the zero-initialised layers count).  Tolerances: forwards and input
gradients as the U-Net's (``tests/test_torch_unet.py``: rtol 1e-4, atol
1e-5, float32 convolutions and GroupNorm summed in other orders); the
resize rtol 1e-5, atol 1e-6 times the input's largest magnitude (two
float32 weighted sums, a few ulps of the largest input apart); trained
states under the AdamW allowance of ``tests/test_torch_diffusion_train.py``
(every element within 2 lr a step, all but 1% within rtol 1e-4, atol
1e-5, see ``_assert_close_adamw``); losses rtol
1e-4; the guided loops at the forwards' tolerance (each step composes a
U-Net forward and a classifier gradient held to it; the DDIM update's
``1/sqrt(alpha_bar)`` carries a last-bit difference to 1e-4 relative on a few
elements); sharded against one process rtol 1e-5, atol 1e-6
(``tests/test_torch_parallel.py``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml

from confild_tpu.cli import train_classifier as j_cli
from confild_tpu.diffusion import create_gaussian_diffusion as j_create_diffusion
from confild_tpu.models import unet as junet
from confild_tpu.models import unet_extras as jextras
from confild_tpu.train import classifier_trainer as jct
from confild_tpu.utils import logger as jlog
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.cli import train_classifier as t_cli
from confild_tpu_torch.diffusion import create_gaussian_diffusion as t_create_diffusion
from confild_tpu_torch.io import convert
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.models import unet_extras as textras
from confild_tpu_torch.train import classifier_trainer as tct
from confild_tpu_torch.utils import logger as tlog
from torch_parity_utils import limit_torch_threads, perturbed, t

RTOL, ATOL = 1e-4, 1e-5
RESIZE_TOL = dict(rtol=1e-5, atol=1e-6)
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ENCODER = dict(image_size=16, in_channels=1, model_channels=32, out_channels=5,
               num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
               num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True)
CLASSIFIER = dict(image_size=16, classifier_width=32, classifier_depth=1,
                  classifier_attention_resolutions="8", out_channels=3)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _params(jmodel, seed=0):
    return perturbed(jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed))),
                     np.random.default_rng(seed + 1))


def _encoders(pool="attention", **over):
    kw = dict(ENCODER, **over)
    jm = jextras.EncoderUNetModel(junet.UNetConfig(**kw), pool=pool, encoder_out_channels=5)
    tm = textras.EncoderUNetModel(tunet.UNetConfig(**kw), pool=pool, encoder_out_channels=5)
    params = _params(jm)
    tm.load_state_dict(convert.encoder_state_dict_from_jax(params, tm))
    return jm, params, tm


def _value_and_vjp(jm, params, x, ts, g):
    out, vjp = jax.vjp(lambda v: jm.apply(params, v, ts), x)
    return out, vjp(g)[0]


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the U-Net's class_cond, bilinear_resize, SuperResModel
# ---------------------------------------------------------------------------

def test_class_cond_unet_matches_jax():
    kw = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
              attention_resolutions="8", num_heads=2, class_cond=True, num_classes=4)
    jm = junet.create_model(**kw)
    tm = tunet.create_model(**kw)
    params = _params(jm)
    sd = convert.unet_state_dict_from_jax(params, tm)
    assert sd["label_emb.weight"].shape == (4, 128)
    tm.load_state_dict(sd)
    x, ts, y = _x((3, 1, 16, 16)), np.array([3, 90, 700]), np.array([0, 3, 1])
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ts),
                                        jnp.asarray(y)))
    with torch.no_grad():
        got = tm(t(x), torch.from_numpy(ts), torch.from_numpy(y))
        other = tm(t(x), torch.from_numpy(ts), torch.from_numpy((y + 1) % 4))
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)
    assert not torch.allclose(got, other)           # the label counts
    with pytest.raises(ValueError, match="labels"):
        tm(t(x), torch.from_numpy(ts))
    # the default initialisation draws the label embedding too
    fresh = tunet.create_model(**kw).reset_parameters(torch.Generator().manual_seed(0))
    assert 0.8 < float(fresh.label_emb.weight.detach().std()) < 1.25


@pytest.mark.parametrize("new_hw", [(32, 32), (24, 40), (8, 8), (5, 11)])
def test_bilinear_resize_matches_jax_image_resize(new_hw):
    """Up (equal to ``F.interpolate``, ``align_corners=False``) and down
    (antialiased, as ``jax.image.resize``) along each axis."""
    x = _x((2, 3, 16, 16))
    tol = dict(RESIZE_TOL, atol=RESIZE_TOL["atol"] * float(np.abs(x).max()))
    want = np.asarray(jextras.bilinear_resize(jnp.asarray(x), new_hw))
    got = textras.bilinear_resize(t(x), new_hw)
    np.testing.assert_allclose(_np(got), want, **tol)
    if new_hw[0] >= 16 and new_hw[1] >= 16:
        ref = F.interpolate(t(x), size=new_hw, mode="bilinear", align_corners=False)
        np.testing.assert_allclose(_np(got), _np(ref), **tol)


def test_super_res_matches_jax():
    cfg = dict(image_size=16, in_channels=1, model_channels=32, out_channels=1,
               num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2)
    jm = jextras.SuperResModel(junet.UNetConfig(**cfg))
    tm = textras.SuperResModel(tunet.UNetConfig(**cfg))
    params = _params(jm)
    tm.load_state_dict(convert.unet_state_dict_from_jax(params, tm))
    x, low, ts = _x((2, 1, 16, 16)), _x((2, 1, 8, 8), 3), np.array([0, 5])
    want = np.asarray(jax.jit(lambda p, v, tt, lo: jm.apply(p, v, tt, low_res=lo))(
        params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(low)))
    with torch.no_grad():
        got = tm(t(x), torch.from_numpy(ts), low_res=t(low))
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)
    sr = textras.create_sr_model(16, 8, 32, 1, attention_resolutions="8")
    assert sr.cfg.in_channels == 2 and sr.cfg.channel_mult == (1, 2, 4)
    with pytest.raises(ValueError, match="low_res"):
        tm(t(x), torch.from_numpy(ts))


# ---------------------------------------------------------------------------
# EncoderUNetModel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_encoder_pools_match_jax(pool):
    """Each pool's logits and the gradient of ``sum(logits * g)`` with
    respect to the input, channels-first and channels-last."""
    jm, params, tm = _encoders(pool)
    x, ts = _x((2, 1, 16, 16)), np.array([3, 700])
    g = _x((2, 5), 4)
    want, want_dx = jax.jit(lambda v: _value_and_vjp(jm, params, v, jnp.asarray(ts),
                                                     jnp.asarray(g)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = tm(xt, torch.from_numpy(ts))
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        last = tm(t(x).permute(0, 2, 3, 1), torch.from_numpy(ts), channels_first=False)
    np.testing.assert_allclose(_np(last), _np(got), rtol=1e-6, atol=1e-6)


def test_encoder_dims3_matches_jax():
    """A 3-D classifier (the torso downsamples the last two axes only; the
    attention pool's tokens are D * (H / ds) * (W / ds))."""
    jm = jextras.create_classifier(image_size=8, classifier_width=32, classifier_depth=1,
                                   classifier_attention_resolutions="4", out_channels=3,
                                   dims=3)
    tm = textras.create_classifier(image_size=8, classifier_width=32, classifier_depth=1,
                                   classifier_attention_resolutions="4", out_channels=3,
                                   dims=3)
    params = _params(jm)
    tm.load_state_dict(convert.encoder_state_dict_from_jax(params, tm))
    assert tm.out[2].positional_embedding.shape == (64, 8 * 4 * 4 + 1)
    x, ts = _x((1, 1, 8, 8, 8)), np.array([7])
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ts)))
    with torch.no_grad():
        got = tm(t(x), torch.from_numpy(ts))
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)


def test_attention_pool_matches_jax():
    """The pool alone against ``EncoderUNetModel._attention_pool`` (the
    reference ``AttentionPool2d`` layout of ``tests/test_extras.py:58-94``)."""
    jm, params, tm = _encoders("attention")
    h = _x((2, 8, 8, 64), 6)                                 # channels-last
    want = np.asarray(jm._attention_pool(params["attn_pool"], jnp.asarray(h)))
    with torch.no_grad():
        got = tm.out[2](t(h).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


def test_encoder_init_and_plan():
    """``build_encoder_plan``'s feature size and width as JAX's; the
    default initialisation zeroes what the JAX init zeroes."""
    for pool in ("adaptive", "spatial"):
        jm, _, tm = _encoders(pool)
        assert (tm.plan.ch_final, tm.plan.feature_size) == (jm.plan.ch_final,
                                                            jm.plan.feature_size)
    tm = textras.EncoderUNetModel(tunet.UNetConfig(**ENCODER), pool="adaptive",
                                  encoder_out_channels=5)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    assert float(tm.out[3].weight.abs().max()) == 0.0
    with torch.no_grad():
        assert float(tm(t(_x((1, 1, 16, 16))), torch.tensor([1])).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# ClassifierTrainLoop and classifier_cond_fn
# ---------------------------------------------------------------------------

def _jax_step_draws(key, shape, n_t):
    """What ``ClassifierTrainLoop.run_step`` draws: ``split`` of the loop's
    key, then ``t`` and the noise from the halves of ``split(key)``."""
    rng, key = jax.random.split(key)
    kt, kn = jax.random.split(key)
    t_draw = jax.random.randint(kt, (shape[0],), 0, n_t)
    noise = jax.random.normal(kn, shape, jnp.float32)
    return rng, torch.from_numpy(np.asarray(t_draw, np.int64)), torch.from_numpy(np.array(noise))


def _loops(tmp_path, **kw):
    jlog.configure(str(tmp_path / "jlogs"), [])
    tlog.configure(str(tmp_path / "tlogs"), [])
    jclf = jextras.create_classifier(**CLASSIFIER)
    tclf = textras.create_classifier(**CLASSIFIER)
    jd = j_create_diffusion(steps=20, noise_schedule="cosine")
    td = t_create_diffusion(steps=20, noise_schedule="cosine")
    jloop = jct.ClassifierTrainLoop(model=jclf, diffusion=jd, data=None, batch_size=4,
                                    save_dir=str(tmp_path / "j"), seed=0, **kw)
    tclf.load_state_dict(convert.encoder_state_dict_from_jax(
        jax.tree.map(np.asarray, jloop.state.params), tclf))
    tloop = tct.ClassifierTrainLoop(model=tclf, diffusion=td, data=None, batch_size=4,
                                    save_dir=str(tmp_path / "t"), seed=0, device="cpu", **kw)
    return jloop, tloop


def _batch(step):
    rng = np.random.default_rng(10 + step)
    y = rng.integers(0, 3, size=4).astype(np.int32)
    x = (0.1 * rng.standard_normal((4, 1, 16, 16)) + (y[:, None, None, None] - 1) * 0.5)
    return np.clip(x, -1, 1).astype(np.float32), y


def _jax_grads(jloop, tmodel, x, y, t_draw, noise):
    """The JAX step's gradient at the loop's current parameters
    (``classifier_trainer.py:99-106``)."""
    def loss(p):
        xt = jnp.asarray(x)
        tt = jnp.asarray(t_draw.numpy())
        if jloop.noised:
            xt = jloop.diffusion.q_sample(xt, tt, jnp.asarray(noise.numpy()))
        logits = jloop.model.apply(p, xt, tt).astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
    return convert.encoder_state_dict_from_jax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(jloop.state.params)), tmodel)


def _assert_close_adamw(got: dict, want: dict, lr: float, steps: int):
    """AdamW's first update is ``lr * sign(g)`` for every element whose
    gradient passes ``eps``, so an element whose gradient is within float32
    noise of 0 steps by lr either way, and the next steps' gradients carry
    that difference on: every element within 2 lr a step, and at most 1% of
    them beyond ``rtol 1e-4, atol 1e-5`` (measured: under 0.1% with noised
    inputs, 0.35% with clean ones, whose first gradients have more elements
    near 0)."""
    assert set(got) == set(want)
    far, total = 0, 0
    for k, v in want.items():
        a, b = got[k].detach().numpy(), v.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * steps, err_msg=k)
        far += int(np.sum(np.abs(a - b) > 1e-5 + 1e-4 * np.abs(b)))
        total += b.size
    assert far <= 0.01 * total, (far, total)


@pytest.mark.parametrize("noised", [True, False])
def test_classifier_loop_steps_match_jax(tmp_path, noised):
    """Three AdamW steps at lr 3e-3 annealed to 0 over 4 steps (weight decay
    0.05), fed the JAX loop's ``t`` and noise: the first step's gradient
    (rtol 1e-4, atol 1e-5 of the largest gradient), each step's loss and
    accuracy (rtol 1e-4) and the parameters after it agree; the saved
    checkpoint reads back."""
    jloop, tloop = _loops(tmp_path, lr=3e-3, lr_anneal_steps=4, noised=noised)
    key = jloop.rng
    for step in range(3):
        x, y = _batch(step)
        key, t_draw, noise = _jax_step_draws(key, x.shape, 20)
        if step == 0:
            grads0 = _jax_grads(jloop, tloop.model, x, y, t_draw, noise)
        jm = jloop.run_step(x, y)
        tm = tloop.train_step(x, y, t_draw, noise)
        np.testing.assert_allclose([tm["loss"], tm["acc"]],
                                   [float(jm["loss"]), float(jm["acc"])], rtol=1e-4)
        if step == 0:       # the same parameters: the same gradient
            scale = max(float(g.abs().max()) for g in grads0.values())
            for k, p in tloop.model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), grads0[k].numpy(), rtol=1e-4,
                                           atol=1e-5 * scale, err_msg=k)
        want = convert.encoder_state_dict_from_jax(
            jax.tree.map(np.asarray, jloop.state.params), tloop.model)
        _assert_close_adamw(tloop.model.state_dict(), want, lr=3e-3, steps=step + 1)
    assert tloop.step == int(jloop.state.step) == 3
    assert tloop._lr() == pytest.approx(3e-3 * 0.25)
    paths = tloop.save()
    saved = torch.load(paths["model"], weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in tloop.model.state_dict().items())
    assert os.path.exists(paths["opt"])


def _guidance_models():
    """``tests/test_extras.py::TestClassifierGuidance._setup``'s U-Net and
    classifier (perturbed), in both packages."""
    model_kw = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
                    attention_resolutions="8", num_heads=2, out_channels=1)
    clf_kw = dict(image_size=16, classifier_width=64, classifier_depth=1,
                  classifier_attention_resolutions="8", out_channels=4)
    jmodel, jclf = junet.create_model(**model_kw), jextras.create_classifier(**clf_kw)
    params, clf_params = _params(jmodel, 0), _params(jclf, 1)
    tmodel, tclf = tunet.create_model(**model_kw), textras.create_classifier(**clf_kw)
    tmodel.load_state_dict(convert.unet_state_dict_from_jax(params, tmodel))
    tclf.load_state_dict(convert.encoder_state_dict_from_jax(clf_params, tclf))
    tmodel.requires_grad_(False)
    tclf.requires_grad_(False)
    return (jmodel, params, jclf, clf_params), (tmodel, tclf)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_classifier_cond_fn_loops_match_jax(sampler):
    """``classifier_cond_fn`` at scale 5 for label 2 through
    ``condition_mean`` (DDPM) and ``condition_score`` (DDIM), the port fed
    the JAX loops' draws; the guided sample differs from the unguided."""
    (jmodel, params, jclf, clf_params), (tmodel, tclf) = _guidance_models()
    jd = j_create_diffusion(steps=6, noise_schedule="cosine")
    td = t_create_diffusion(steps=6, noise_schedule="cosine")
    jparams = jax.tree.map(jnp.asarray, params)
    jcond = jct.classifier_cond_fn(jclf, jax.tree.map(jnp.asarray, clf_params), scale=5.0)
    tcond = tct.classifier_cond_fn(tclf, scale=5.0)
    shape = (1, 1, 16, 16)
    key = jax.random.key(7)
    noise_key, loop_key = jax.random.split(key)
    img = torch.from_numpy(np.array(jax.random.normal(noise_key, shape, jnp.float32)))
    draws = {i: torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(loop_key, i),
                                                            shape, jnp.float32)))
             for i in range(6)}
    y = np.array([2])

    def jfn(x, tt, **kw):
        return jmodel.apply(jparams, x, tt)
    loop = "p_sample_loop" if sampler == "ddpm" else "ddim_sample_loop"
    want = getattr(jd, loop)(jfn, shape, key, cond_fn=jcond,
                             model_kwargs={"y": jnp.asarray(y)})
    got = getattr(td, loop)(tmodel, shape, noise=img, step_noise=lambda i: draws[i],
                            cond_fn=tcond, model_kwargs={"y": torch.from_numpy(y)})
    plain = getattr(td, loop)(tmodel, shape, noise=img, step_noise=lambda i: draws[i])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert float((got - plain).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="labels"):
        tcond(img, torch.tensor([1]))


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------

def _cli_recipe(root, **over):
    rng = np.random.default_rng(0)
    labels = np.arange(12) % 2
    data = (rng.standard_normal((12, 16, 16)) * 0.3 + labels[:, None, None] * 2.0 - 1.0)
    np.save(root / "latents.npy", data.astype(np.float32))
    np.save(root / "labels.npy", labels)
    recipe = dict(train_data_path=str(root / "latents.npy"), label_path=str(root / "labels.npy"),
                  image_size=16, classifier_width=32, classifier_depth=1,
                  classifier_attention_resolutions="8", out_channels=2, batch_size=4,
                  lr=3e-3, lr_anneal_steps=3, steps=20, noise_schedule="cosine",
                  log_interval=1, log_path=str(root / "logs"), device="cpu")
    recipe.update(over)
    (root / "case.yml").write_text(yaml.safe_dump(recipe))
    return str(root / "case.yml")


class _Captured(Exception):
    pass


@pytest.mark.parametrize("scale", ["minmax", "explicit", "diffusion_log"])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, scale):
    """The port's CLI against the JAX CLI on one recipe under each branch of
    the scale contract: the same normalized batches and labels, the same
    classifier (its state-dict keys are the JAX parameters'), the loop's
    settings; then the port's CLI trains to the end, logs loss and accuracy
    and writes the checkpoint pair."""
    over = {}
    if scale == "explicit":
        over = dict(data_max=3.0, data_min=-2.0)
    elif scale == "diffusion_log":
        (tmp_path / "diff").mkdir()
        np.save(tmp_path / "diff" / "data_max.npy", np.float32(2.5))
        np.save(tmp_path / "diff" / "data_min.npy", np.float32(-1.5))
        over = dict(diffusion_log_path=str(tmp_path / "diff"))
    path = _cli_recipe(tmp_path, **over)
    seen = {}

    class JStub:
        def __init__(self, **kw):
            seen["jax"] = kw
            raise _Captured
    monkeypatch.setattr(j_cli, "ClassifierTrainLoop", JStub)
    with pytest.raises(_Captured):
        j_cli.main([path])
    jkw = seen["jax"]
    batches = t_cli.labeled_batches(*t_cli.load_labeled_data(tconfig.basic_input(path)), 4)
    for _ in range(3):
        (jx, jy), (tx, ty) = next(jkw["data"]), next(batches)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    loop = t_cli.main([path])
    for k in ("batch_size", "lr", "lr_anneal_steps", "noised", "log_interval",
              "save_interval", "keep_checkpoints"):
        assert getattr(loop, k) == jkw[k], k
    assert loop.opt.param_groups[0]["weight_decay"] == jkw["weight_decay"]
    jparams = jax.tree.map(np.asarray, jkw["model"].init(jax.random.key(0)))
    assert sorted(convert.encoder_state_dict_from_jax(jparams, loop.model)) == \
        sorted(loop.model.state_dict())
    assert loop.diffusion.num_timesteps == jkw["diffusion"].num_timesteps
    assert loop.step == 3
    logs = tmp_path / "logs"
    assert (logs / "model000003.pt").exists() and (logs / "opt000003.pt").exists()
    rows = (logs / "progress.csv").read_text().splitlines()
    assert rows[0].split(",") and {"loss", "acc", "step"} <= set(rows[0].split(","))
    assert len(rows) == 4


# ---------------------------------------------------------------------------
# two gloo ranks against one process
# ---------------------------------------------------------------------------

WORKER = os.path.join(HERE, "torch_parallel_worker.py")
JOIN_TIMEOUT_S = 300
SHARD_TOL = dict(rtol=1e-5, atol=1e-6)


def test_two_gloo_ranks_match_one_process(tmp_path):
    """``ClassifierTrainLoop(mesh=)`` on two gloo ranks (child processes,
    ``tests/torch_parallel_worker.py``'s ``classifier`` task): each takes
    its half of the global batch of 4 and its draws, DDP averages the
    gradients; two steps give the one-process losses, accuracies and
    gradients (``SHARD_TOL``; the gradients' atol scaled by their largest)
    and parameters (``_assert_close_adamw``), and rank 0's checkpoint reads
    back on both ranks."""
    tclf = textras.create_classifier(**CLASSIFIER).reset_parameters(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    steps = []
    for step in range(2):
        x, y = _batch(step)
        steps.append((torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
                      torch.randint(0, 20, (4,), generator=gen),
                      torch.randn((4, 1, 16, 16), generator=gen)))
    torch.save({"config": CLASSIFIER, "state_dict": tclf.state_dict(), "steps": steps},
               tmp_path / "classifier.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(tmp_path), "classifier"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    tlog.configure(str(tmp_path / "one_logs"), [])
    one = tct.ClassifierTrainLoop(model=tclf, diffusion=t_create_diffusion(
        steps=20, noise_schedule="cosine"), data=None, batch_size=4, lr=3e-3,
        lr_anneal_steps=4, save_dir=str(tmp_path / "one"), device="cpu")
    one_metrics = [one.train_step(*step) for step in steps]
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=JOIN_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} did not finish in {JOIN_TIMEOUT_S} s")
        assert p.returncode == 0 and f"rank {r} OK" in out, out[-6000:]
    for r in range(2):
        got = torch.load(tmp_path / f"classifier_rank{r}.pt", weights_only=False)
        for m, w in zip(got["metrics"], one_metrics):
            np.testing.assert_allclose([m["loss"], m["acc"]], [w["loss"], w["acc"]],
                                       **SHARD_TOL)
        for k, p in one.model.named_parameters():
            np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), err_msg=k,
                                       rtol=SHARD_TOL["rtol"],
                                       atol=SHARD_TOL["atol"] * max(1.0, float(p.grad.abs().max())))
        # the second step starts from AdamW's sign-like first update
        _assert_close_adamw(got["params"], one.model.state_dict(), lr=3e-3, steps=2)
        assert got["read_back"]
