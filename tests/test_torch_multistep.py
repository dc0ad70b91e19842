"""Port vs JAX package for multi-step diffusion training: ``TrainLoop``
with ``steps_per_call > 1`` (``run_steps``) over a device-resident training
array (``device_data``) and over iterators with and without validation
data, on ``tests/test_diffusion_trainer.py``'s tiny U-Net.

The port draws its own indices, timesteps and noise; here it is fed the JAX
loop's: for each step the gathered indices from ``k_idx`` and ``t`` and the
noise from ``k_step`` (``confild_tpu/train/diffusion_trainer.py:283-295``),
as ``tests/test_torch_diffusion_train.py`` does for one step.  The logged
means, the parameters and the EMAs are held at that file's tolerances
(metrics rtol 1e-4; states within 2 lr a step, all but 0.1% of elements
within rtol 1e-4, atol 1e-5)."""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from confild_tpu.diffusion import create_gaussian_diffusion as j_create_diffusion
from confild_tpu.models import unet as junet
from confild_tpu.train.diffusion_trainer import TrainLoop as JTrainLoop
from confild_tpu.train.diffusion_trainer import load_latent_image_data as j_load_data
from confild_tpu.utils import logger as jlog
from confild_tpu_torch.diffusion import create_gaussian_diffusion as t_create_diffusion
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.train.diffusion_trainer import TrainLoop, load_latent_image_data
from confild_tpu_torch.utils import logger as tlog
from test_torch_diffusion_train import (UNET, _assert_close_trained, _data, _jax_draws,
                                        _state_dict)
from torch_parity_utils import limit_torch_threads

LR = 1e-3
METRICS = ("loss", "mse", "grad_norm", "param_norm", "loss_q0", "loss_q1", "loss_q2",
           "loss_q3", "skipped_nonfinite")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _images(n=12, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 1, 16, 16)).astype(np.float32).clip(-1, 1)


def _pair(tmp_path, **kw):
    """The JAX loop and the port's, from the same initial weights, each
    with its package's logger writing a CSV."""
    jlog.configure(str(tmp_path / "jlogs"), ["csv"])
    jloop = JTrainLoop(model=junet.create_model(**UNET),
                       diffusion=j_create_diffusion(steps=20, noise_schedule="cosine"),
                       batch_size=8, lr=LR, ema_rate="0.5,0.9", save_dir=str(tmp_path / "j"),
                       **kw)
    tm = tunet.create_model(**UNET)
    tm.load_state_dict(_state_dict(jloop.state.params, tm))
    tlog.configure(str(tmp_path / "tlogs"), ["csv"])
    tloop = TrainLoop(model=tm, diffusion=t_create_diffusion(steps=20, noise_schedule="cosine"),
                      batch_size=8, lr=LR, ema_rate="0.5,0.9", save_dir=str(tmp_path / "t"),
                      device="cpu", **kw)
    return jloop, tloop


def _multi_draws(jloop, k, valid=False, vshape=None):
    """What the JAX loop's next ``run_steps(k)`` draws, from its current
    key: per step the device-data indices (or None) and the training draws,
    and with ``valid`` the validation draws."""
    _, sub = jax.random.split(jloop.key)
    steps = []
    for key in jax.random.split(sub, k):
        if jloop.device_data is not None:
            k_idx, k_step = jax.random.split(key)
            idx = np.asarray(jax.random.randint(k_idx, (jloop.batch_size,), 0,
                                                jloop.device_data.shape[0]))
            shape = (jloop.batch_size, *jloop.device_data.shape[1:])
            steps.append((idx, _jax_draws(k_step, shape, jloop.sampler), None))
        elif valid:
            k1, k2 = jax.random.split(key)
            shape = (jloop.batch_size, 1, 16, 16)
            steps.append((None, _jax_draws(k1, shape, jloop.sampler),
                          _jax_draws(k2, vshape, jloop.sampler)))
        else:
            steps.append((None, _jax_draws(key, (jloop.batch_size, 1, 16, 16),
                                           jloop.sampler), None))
    return steps


def _feed(tloop, queue):
    """Make the port's loop take its indices and draws from ``queue`` (a
    list of ``_multi_draws`` steps, consumed in order)."""
    draws = []

    def device_batch():
        idx, train, vdraw = queue.pop(0)
        draws.extend([train] + ([vdraw] if vdraw is not None else []))
        return tloop.device_data[torch.from_numpy(np.array(idx))]

    def next_draws(batch):
        if not draws:
            _, train, vdraw = queue.pop(0)
            draws.extend([train] + ([vdraw] if vdraw is not None else []))
        return draws.pop(0)
    tloop.device_batch = device_batch
    tloop._draws = next_draws


def _assert_same_logged(got: dict, want: dict):
    assert got["step"] == want["step"] and got["samples"] == want["samples"]
    for k in METRICS + ("valid_mse",):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            assert k not in got, k      # no finite value in the call


def _assert_same_state(jloop, tloop, steps):
    _assert_close_trained(tloop.model.state_dict(),
                          _state_dict(jloop.state.params, tloop.model), lr=LR, steps=steps)
    for i, ema in enumerate(jloop.state.ema_params):
        _assert_close_trained(tloop.ema_state_dict(i), _state_dict(ema, tloop.model),
                              lr=LR, steps=steps)


def test_run_steps_device_data_matches_jax(tmp_path):
    """Two calls of ``run_steps(3)`` over a resident set of 12 images: each
    call's logged means (over its finite values), the step count, and after
    six steps the parameters and both EMAs."""
    images = _images()
    jloop, tloop = _pair(tmp_path, data=None, device_data=images, steps_per_call=3,
                         lr_anneal_steps=8, weight_decay=1e-2)
    assert tloop.device_data.shape == images.shape and tloop.steps_per_call == 3
    for _ in range(2):
        queue = _multi_draws(jloop, 3)
        _feed(tloop, queue)
        jloop.run_steps(3)
        tloop.run_steps(3)
        assert not queue
        _assert_same_logged(tlog.get_current().dumpkvs(), jlog.get_current().dumpkvs())
    assert tloop.step == int(jloop.state.step) == 6
    _assert_same_state(jloop, tloop, 6)


@pytest.mark.parametrize("valid", [False, True])
def test_run_steps_iterators_match_jax(tmp_path, valid):
    """``run_steps(3)`` on iterator data, k batches a call, and with
    ``valid_data`` k validation batches, each step followed by its
    validation forward (``valid_mse`` logged as the call's mean)."""
    train, valid_path = _data(tmp_path)
    jdata, jvalid, _ = j_load_data(train, valid_path if valid else None, batch_size=8)
    tdata, tvalid, _ = load_latent_image_data(train, valid_path if valid else None,
                                              batch_size=8)
    jloop, tloop = _pair(tmp_path, data=jdata, valid_data=jvalid, steps_per_call=3)
    tloop.data, tloop.valid_data = tdata, tvalid
    for _ in range(2):
        queue = _multi_draws(jloop, 3, valid=valid, vshape=(8, 1, 16, 16))
        _feed(tloop, queue)
        jloop.run_steps(3)
        tloop.run_steps(3)
        assert not queue
        got, want = tlog.get_current().dumpkvs(), jlog.get_current().dumpkvs()
        assert ("valid_mse" in got) == ("valid_mse" in want) == valid
        _assert_same_logged(got, want)
    assert tloop.step == int(jloop.state.step) == 6
    _assert_same_state(jloop, tloop, 6)


def test_device_data_with_valid_data_raises(tmp_path):
    """``device_data`` takes no validation iterator, in both packages."""
    train, valid_path = _data(tmp_path)
    _, jvalid, _ = j_load_data(train, valid_path, batch_size=8)
    _, tvalid, _ = load_latent_image_data(train, valid_path, batch_size=8)
    with pytest.raises(ValueError, match="valid_data"):
        JTrainLoop(model=junet.create_model(**UNET),
                   diffusion=j_create_diffusion(steps=20, noise_schedule="cosine"), data=None,
                   batch_size=8, device_data=_images(), valid_data=jvalid,
                   save_dir=str(tmp_path / "j"))
    with pytest.raises(ValueError, match="valid_data"):
        TrainLoop(model=tunet.create_model(**UNET),
                  diffusion=t_create_diffusion(steps=20, noise_schedule="cosine"), data=None,
                  batch_size=8, device_data=_images(), valid_data=tvalid, device="cpu",
                  save_dir=str(tmp_path / "t"))


def test_device_batch_gathers_resident_rows(tmp_path):
    """The port's own draw: ``batch_size`` rows of the resident array, at
    indices from the loop's device generator (seeded: two loops agree)."""
    images = _images()
    loops = [TrainLoop(model=tunet.create_model(**UNET),
                       diffusion=t_create_diffusion(steps=20, noise_schedule="cosine"),
                       data=None, batch_size=8, device_data=images, device="cpu",
                       save_dir=str(tmp_path / f"t{i}")) for i in range(2)]
    a, b = loops[0].device_batch(), loops[1].device_batch()
    assert a.shape == (8, 1, 16, 16) and torch.equal(a, b)
    rows = {tuple(r.flatten().tolist()) for r in torch.from_numpy(images)}
    assert all(tuple(r.flatten().tolist()) in rows for r in a)


def _csv(path):
    with open(os.path.join(path, "progress.csv")) as f:
        return list(csv.DictReader(f))


def test_run_loop_cadence_matches_jax(tmp_path):
    """``run_loop`` at ``steps_per_call`` 4 with ``lr_anneal_steps`` 10, a
    log every 3 and a save every 5 steps: calls end at steps 4, 8 and 12
    (a call may pass the horizon), a CSV row where ``step % 3 < 4``, saves
    where ``step % 5 < 4`` past 5 and at the end; the rows' values and the
    saved steps agree with the JAX loop's."""
    images = _images()
    jloop, tloop = _pair(tmp_path, data=None, device_data=images, steps_per_call=4,
                         lr_anneal_steps=10, log_interval=3, save_interval=5)
    queue = []
    run_steps = jloop.run_steps

    def recording(k):
        queue.extend(_multi_draws(jloop, k))
        run_steps(k)
    jloop.run_steps = recording
    jloop.run_loop()
    _feed(tloop, queue)
    tloop.run_loop()
    assert not queue
    assert tloop.step == int(jloop.state.step) == 12
    jrows, trows = _csv(str(tmp_path / "jlogs")), _csv(str(tmp_path / "tlogs"))
    assert [int(r["step"]) for r in trows] == [int(r["step"]) for r in jrows] == [4, 8, 12]
    for got, want in zip(trows, jrows):
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    stems = lambda d: sorted(os.path.splitext(f)[0] for f in os.listdir(d))
    assert stems(tmp_path / "t") == stems(tmp_path / "j")
    assert "model000008" in stems(tmp_path / "t") and "model000012" in stems(tmp_path / "t")


@pytest.mark.parametrize("valid", [False, True])
def test_run_step_is_run_steps_of_one(tmp_path, valid):
    """``run_step`` on a batch and ``run_steps(1)`` taking the same batch
    from ``data`` make the same step, bitwise: parameters, both EMAs and
    the logged metrics (``samples`` aside, which JAX logs one step apart
    on the two paths)."""
    train, valid_path = _data(tmp_path)
    loops, logged = [], []
    for i in range(2):
        data, vdata, _ = load_latent_image_data(train, valid_path if valid else None,
                                                batch_size=8)
        tm = tunet.create_model(**UNET)
        tm.reset_parameters(torch.Generator().manual_seed(7))
        tlog.configure(str(tmp_path / f"logs{i}"), [])
        loop = TrainLoop(model=tm, diffusion=t_create_diffusion(steps=20,
                                                                noise_schedule="cosine"),
                         data=data, valid_data=vdata, batch_size=8, lr=LR,
                         ema_rate="0.5,0.9", save_dir=str(tmp_path / f"t{i}"), device="cpu")
        if i == 0:
            loop.run_step(next(data)[0])
        else:
            loop.run_steps(1)
        loops.append(loop)
        logged.append(tlog.get_current().dumpkvs())
    assert loops[0].step == loops[1].step == 1
    for (name, a), b in zip(loops[0].model.state_dict().items(),
                            loops[1].model.state_dict().values()):
        assert torch.equal(a, b), name
    for i in range(2):
        assert all(torch.equal(a, b) for a, b in zip(loops[0].ema_params[i],
                                                     loops[1].ema_params[i]))
    assert ("valid_mse" in logged[0]) == ("valid_mse" in logged[1]) == valid
    assert {k: v for k, v in logged[0].items() if k != "samples"} == \
        {k: v for k, v in logged[1].items() if k != "samples"}
