"""Port vs JAX package for the evaluation tools: every ``analysis.metrics``
function (float64 inputs, 1e-12), the ``Resizer`` with each kernel at up,
down and mixed scales (1e-5), ``img_utils`` (the same masks from the same
seed; thresholding and the bicubic resize), the logger's writers (byte for
byte against the JAX logger's files) and the profiling helpers on the
CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu.analysis import metrics as jm
from confild_tpu.utils import img_utils as jimg
from confild_tpu.utils import logger as jlog
from confild_tpu.utils.resizer import Resizer as JResizer
from confild_tpu_torch.analysis import metrics as tm
from confild_tpu_torch.utils import img_utils as timg
from confild_tpu_torch.utils import logger as tlog
from confild_tpu_torch.utils import profiling
from confild_tpu_torch.utils.resizer import Resizer as TResizer
from torch_parity_utils import limit_torch_threads, t

METRIC_TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _ar_field(seed, n_t=300, space=(6, 6), rho=0.7):
    """An autoregressive (time, *space) field: a finite integral timescale."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_t, *space))
    noise = rng.normal(size=(n_t, *space))
    for i in range(1, n_t):
        x[i] = rho * x[i - 1] + noise[i]
    return x


def _fields(seed, shape=(3, 16, 20)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape) * 1.3 + 0.2


METRIC_CASES = {
    "per_channel_mse": lambda m: m.per_channel_mse(*_fields(0, (4, 5, 6, 3))),
    "per_channel_rmae": lambda m: m.per_channel_rmae(*_fields(1, (4, 5, 6, 3))),
    "temporal_autocorrelation": lambda m: m.temporal_autocorrelation(_ar_field(2)),
    "autocorr_cutoff": lambda m: [
        m.autocorr_cutoff(m.temporal_autocorrelation(_ar_field(3))),
        m.autocorr_cutoff(np.array([1.0, 0.5, 0.2, 0.04, 0.01])),
        m.autocorr_cutoff(np.array([1.0, 0.6, 0.4, 0.5, 0.6, 0.3])),
        m.autocorr_cutoff(np.array([1.0, 0.9, 0.8])),
        m.autocorr_cutoff(np.array([1.0, 0.9, 0.8, 0.7, 0.6]), threshold=0.65)],
    "integral_timescale": lambda m: [m.integral_timescale(_ar_field(4), 0.1),
                                     m.integral_timescale(_ar_field(5, rho=0.95), 0.02)],
    "energy_spectrum_1d": lambda m: np.concatenate(
        m.energy_spectrum_1d(_fields(6)[0], axis=1, dx=0.5)),
    "energy_spectrum_radial": lambda m: np.concatenate(
        m.energy_spectrum_radial(_fields(7)[0], dx=0.25)),
    "two_point_correlation": lambda m: m.two_point_correlation(_fields(8)[0], axis=-1),
    "spectra_relative_error": lambda m: m.spectra_relative_error(*_fields(9), axis=-2),
    "velocity_pdf": lambda m: np.concatenate(
        m.velocity_pdf(_fields(10)[1], bins=41, span_sigma=4.0)
        + m.velocity_pdf(_fields(11)[1], standardize=False)),
    "pdf_jensen_shannon": lambda m: [m.pdf_jensen_shannon(*_fields(12)),
                                     m.pdf_jensen_shannon(*_fields(13), bins=21)],
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metric_matches_jax(name):
    want = np.asarray(METRIC_CASES[name](jm), np.float64)
    got = np.asarray(METRIC_CASES[name](tm), np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **METRIC_TOL)


def _resize_pair(in_shape, seed=0, **kw):
    x = np.random.default_rng(seed).standard_normal(in_shape).astype(np.float32)
    want = np.asarray(JResizer(in_shape, **kw)(jnp.asarray(x)))
    got = TResizer(in_shape, **kw)(t(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", [None, "cubic", "lanczos2", "lanczos3", "box", "linear"])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_resizer_kernels_match_jax(kernel, scale):
    _resize_pair((12, 16), scale_factor=scale, kernel=kernel)


@pytest.mark.parametrize("kw", [
    dict(in_shape=(3, 16, 16), scale_factor=0.25),
    dict(in_shape=(12, 12), scale_factor=[0.5, 2.0]),
    dict(in_shape=(15, 15), scale_factor=2 / 3),
    dict(in_shape=(16, 16), output_shape=[10, 6]),
    dict(in_shape=(16, 16), scale_factor=0.5, antialiasing=False),
], ids=["scalar-3d", "mixed", "non-integer", "output-shape", "no-antialias"])
def test_resizer_shapes_match_jax(kw):
    _resize_pair(**kw)


def test_resizer_is_differentiable_and_rejects_unknown_kernels():
    x = torch.ones(8, 8, requires_grad=True)
    (TResizer((8, 8), scale_factor=0.5)(x) ** 2).sum().backward()
    assert x.grad.shape == (8, 8) and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError):
        TResizer((8, 8), scale_factor=0.5, kernel="nope")


def test_thresholding_matches_jax():
    x = np.random.default_rng(14).standard_normal((2, 1, 9, 7)).astype(np.float32) * 2
    for fn in ("normalize", "dynamic_thresholding"):
        np.testing.assert_allclose(getattr(timg, fn)(t(x), 0.9).numpy(),
                                   np.asarray(getattr(jimg, fn)(jnp.asarray(x), 0.9)),
                                   rtol=1e-6, atol=1e-6, err_msg=fn)


@pytest.mark.parametrize("mask_type,kw", [
    ("box", dict(mask_len_range=(8, 20))),
    ("extreme", dict(mask_len_range=(8, 20))),
    ("random", dict(mask_prob_range=(0.3, 0.7))),
    ("std_box", dict(std_box_hstart=3, std_box_wstart=5, h=7, w=4)),
])
def test_masks_match_jax_given_the_seed(mask_type, kw):
    shape = (2, 1, 48, 48)
    jgen = jimg.mask_generator(mask_type, image_size=48, margin=(4, 4), seed=21, **kw)
    tgen = timg.mask_generator(mask_type, image_size=48, margin=(4, 4), seed=21, **kw)
    for _ in range(3):     # the generators advance alike
        want = np.asarray(jgen(shape))
        got = tgen(torch.zeros(shape))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_random_sq_bbox_matches_jax():
    want = jimg.random_sq_bbox((1, 1, 32, 32), (6, 9), 32, (3, 3), np.random.default_rng(5))
    got = timg.random_sq_bbox((1, 1, 32, 32), (6, 9), 32, (3, 3), np.random.default_rng(5))
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    with pytest.raises(ValueError, match="Generator"):
        timg.random_sq_bbox((1, 1, 32, 32), (6, 9), 32, (3, 3))


@pytest.mark.parametrize("scale", [0.5, 2.0, 0.75])
def test_bicubic_resize_matches_jax(scale):
    x = np.random.default_rng(15).standard_normal((2, 3, 12, 16)).astype(np.float32)
    want = np.asarray(jimg.bicubic_resize(jnp.asarray(x), scale))
    got = timg.bicubic_resize(t(x), scale)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _drive_logger(mod, root, monkeypatch, rank=0):
    """The same calls into either package's logger; returns its directory."""
    monkeypatch.setattr(mod, "_process_index", lambda: rank)
    logger = mod.configure(str(root), ["log", "json", "csv"], log_suffix="_x")
    mod.logkv("step", 1)
    mod.logkv("loss", 0.123456789)
    mod.logkv_mean("mse", 2.0)
    mod.logkv_mean("mse", 3.0)
    mod.logkv("a_very_long_key_name_that_gets_truncated", "text value")
    mod.dumpkvs()
    mod.log("a line", 3, 4.5)
    mod.log("hidden at debug", level=mod.DEBUG)
    mod.set_level(mod.DEBUG) if hasattr(mod, "set_level") else logger.set_level(mod.DEBUG)
    mod.log("shown at debug", level=mod.DEBUG)
    mod.logkv("step", 2)
    mod.logkv("new_key", -1.5e-9)
    mod.dumpkvs()
    logger.close()
    return root


@pytest.mark.parametrize("rank", [0, 2])
def test_logger_writers_match_jax_byte_for_byte(tmp_path, monkeypatch, rank):
    jdir = _drive_logger(jlog, tmp_path / "jax", monkeypatch, rank)
    tdir = _drive_logger(tlog, tmp_path / "torch", monkeypatch, rank)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert names == (["log_x.txt", "progress_x.csv", "progress_x.json"] if rank == 0
                     else ["log_x-rank002.txt"])
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    if rank == 0:
        rows = [json.loads(line) for line in (tdir / "progress_x.json").read_text().splitlines()]
        assert rows[0]["mse"] == 2.5 and rows[1]["new_key"] == -1.5e-9


def test_logger_public_names_match_jax():
    public = {n for n in dir(jlog) if not n.startswith("__") and n not in
              ("annotations", "contextmanager", "Any", "json", "os", "time", "_csv")}
    assert public - set(dir(tlog)) == set()
    assert tlog._process_index() == 0


def test_step_timer_on_cpu(monkeypatch):
    logged = {}
    monkeypatch.setattr(tlog, "logkv", lambda k, v: logged.__setitem__(k, v))
    timer = profiling.StepTimer(decay=0.5, device="cpu")
    assert timer.tick() is None
    first = timer.tick()
    second = timer.tick()
    assert first is not None and first >= 0 and second >= 0
    assert logged["step_time_s"] == second


def test_annotate_and_trace_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("confild_scope"):
            torch.ones(4).sum()
    assert "confild_scope" in {e.name for e in prof.events()}
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))


def test_device_memory_stats_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
    logged = {}
    monkeypatch.setattr(tlog, "logkv", lambda k, v: logged.__setitem__(k, v))
    profiling.log_memory()
    assert logged == {}
