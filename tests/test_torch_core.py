"""Port vs JAX package on the shared numerics: config, normalizers, packing,
schedules (float64 tables held to 1e-12)."""

import dataclasses

import numpy as np
import pytest
import torch

from confild_tpu import config as jconfig
from confild_tpu.core import normalize as jnorm
from confild_tpu.core import packing as jpacking
from confild_tpu.core import schedules as jsched
from confild_tpu_torch import config as tconfig
from confild_tpu_torch.core import normalize as tnorm
from confild_tpu_torch.core import packing as tpacking
from confild_tpu_torch.core import schedules as tsched
from torch_parity_utils import limit_torch_threads


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.mark.parametrize("name", ["linear", "cosine"])
@pytest.mark.parametrize("respacing", [None, "10", "ddim25", "3,5"])
def test_schedule_tables_match_f64(name, respacing):
    j = jsched.named_schedule(name, 100, respacing)
    p = tsched.named_schedule(name, 100, respacing)
    assert p.num_timesteps == j.num_timesteps
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(p, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype, f.name
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12, err_msg=f.name)
        else:
            assert a == b, f.name


def test_extract_gathers_float32_on_host_index():
    s = tsched.named_schedule("cosine", 50, "10")
    x = torch.zeros(3, 1, 4, 4)
    t = torch.tensor([0, 5, 9])
    out = tsched.extract(s.sqrt_alphas_cumprod, t, x)
    assert out.shape == (3, 1, 1, 1) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.reshape(-1).numpy(),
                                  s.sqrt_alphas_cumprod[[0, 5, 9]].astype(np.float32))


@pytest.mark.parametrize("method", ["-11", "01", "ms", "none"])
def test_normalizer_matches_jax(method):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((7, 3)).astype(np.float32)
    params = (rng.uniform(1, 2, (1, 3)).astype(np.float32),
              rng.uniform(-2, -1, (1, 3)).astype(np.float32))
    jn = jnorm.Normalizer(params, method, 0)
    tn = tnorm.Normalizer(params, method, 0)
    want = np.asarray(jn.normalize(data))
    np.testing.assert_allclose(tn.normalize(data), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.to("cpu").normalize(torch.from_numpy(data)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    back = tn.denormalize(torch.from_numpy(want))
    np.testing.assert_allclose(back.numpy(), np.asarray(jn.denormalize(want)),
                               rtol=1e-6, atol=1e-6)


def test_packing_matches_jax():
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(tpacking.create_coordinates_grid((3, 4, 2)),
                                  jpacking.create_coordinates_grid((3, 4, 2)))
    x = rng.uniform(-1, 1, (2, 1, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tpacking.unit_interval_to_minmax(torch.from_numpy(x), 3.0, -2.0).numpy(),
        np.asarray(jpacking.unit_interval_to_minmax(x, 3.0, -2.0)), rtol=1e-6)
    mask = rng.uniform(size=(4, 6)) > 0.5
    vals = rng.standard_normal((int(mask.sum()), 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tpacking.reconstruct_frame(vals, mask, (4, 6), -1.0).numpy(),
        np.asarray(jpacking.reconstruct_frame(vals, mask, (4, 6), -1.0)))
    with pytest.raises(ValueError):
        tpacking.reconstruct_frame(vals[:-1], mask, (4, 6))


def test_config_matches_jax(tmp_path):
    path = tmp_path / "r.yml"
    path.write_text("a: 1\nNF:\n  name: x\nsteps: 10\n")
    j, p = jconfig.basic_input(str(path), steps=3), tconfig.basic_input(str(path), steps=3)
    assert p.to_dict() == j.to_dict() and p.steps == 3 and p.get("zzz", 5) == 5
    with pytest.raises(AttributeError):
        p.zzz
