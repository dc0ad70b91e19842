"""The port's turbulence demo (``confild_tpu_torch/examples``) against the
JAX package's (``examples/demo_turbulence.py``, ``examples/demo_common.py``)
on the CPU: the simulator bitwise, the sliding windows and the ``unet.json``
round trip exactly, the demo U-Net's structure and one bf16 forward (relative
L2 0.02, the bar of ``tests/test_torch_bf16.py``), and the demo itself run
end to end at a tiny size, writing only under its ``--out``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu_torch.examples import demo_common as tdemo_common
from confild_tpu_torch.examples import demo_turbulence as tdemo
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from examples import demo_common as jdemo_common
from examples import demo_turbulence as jdemo
from torch_parity_utils import limit_torch_threads, perturbed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_BF16_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.mark.parametrize("flow", sorted(jdemo.FLOW_PRESETS))
def test_simulator_is_bitwise_the_jax_demos(flow):
    """16^2 grid, 2 snapshots, 1 trajectory, each preset as the demo
    passes it (at 16^2 the forced flows' 3000 burn-in steps overflow in
    both simulators alike: NaN where the other has NaN)."""
    assert tdemo.FLOW_PRESETS == jdemo.FLOW_PRESETS
    kw = tdemo.FLOW_PRESETS[flow]
    with np.errstate(all="ignore"):
        got = tdemo.simulate_turbulence(16, 2, 1, **kw)
        want = jdemo.simulate_turbulence(16, 2, 1, **kw)
    assert got.shape == (1, 2, 16, 16, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isfinite(got)) == np.all(np.isfinite(want))


@pytest.mark.parametrize("window,stride", [(8, 2), (16, 4), (4, 4)])
def test_sliding_windows_match_jax(window, stride):
    x = np.random.default_rng(0).standard_normal((3, 16, 5)).astype(np.float32)
    np.testing.assert_array_equal(tdemo_common.sliding_windows(x, window, stride),
                                  jdemo_common.sliding_windows(x, window, stride))


def test_sliding_windows_errors_match_jax():
    x = np.zeros((2, 10, 3))
    for window, stride in ((12, 1), (8, 3)):
        with pytest.raises(ValueError):
            jdemo_common.sliding_windows(x, window, stride)
        with pytest.raises(ValueError):
            tdemo_common.sliding_windows(x, window, stride)


def test_unet_json_round_trip_matches_jax(tmp_path):
    """The same ``unet.json`` from both packages; each reads the other's;
    a resume with other arguments and a directory holding model
    checkpoints but no ``unet.json`` are refused by both."""
    kw = dict(num_channels=96, channel_mult="1,1,2,2,4")
    a = jdemo_common.save_demo_unet_config(str(tmp_path / "j"), 64, 256, **kw)
    b = tdemo_common.save_demo_unet_config(str(tmp_path / "t"), 64, 256, **kw)
    assert a == b
    assert (tmp_path / "j" / "unet.json").read_text() == (tmp_path / "t" / "unet.json").read_text()
    # each package resumes on the other's file
    assert tdemo_common.save_demo_unet_config(str(tmp_path / "j"), 64, 256, **kw) == a
    assert jdemo_common.save_demo_unet_config(str(tmp_path / "t"), 64, 256, **kw) == b
    for save in (jdemo_common.save_demo_unet_config, tdemo_common.save_demo_unet_config):
        with pytest.raises(ValueError, match="resume mismatch"):
            save(str(tmp_path / "t"), 64, 256, num_channels=64)
    (tmp_path / "jm").mkdir()
    (tmp_path / "jm" / "model000010.ckpt").write_bytes(b"")
    (tmp_path / "tm").mkdir()
    (tmp_path / "tm" / "model000010.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="no unet.json"):
        jdemo_common.save_demo_unet_config(str(tmp_path / "jm"), 64, 256)
    with pytest.raises(ValueError, match="no unet.json"):
        tdemo_common.save_demo_unet_config(str(tmp_path / "tm"), 64, 256)
    with pytest.raises(ValueError, match="no unet.json"):
        tdemo_common.save_demo_unet_config(str(tmp_path / "jm"), 64, 256)
    # the loader rebuilds the persisted construction, and refuses another
    # latent-image shape
    m = tdemo_common.load_demo_unet(str(tmp_path / "j"), 64, 256)
    assert m.cfg.model_channels == 96 and m.cfg.channel_mult == (1, 1, 2, 2, 4)
    with pytest.raises(ValueError, match="does not match"):
        tdemo_common.load_demo_unet(str(tmp_path / "j"), 32, 256)
    assert tdemo_common.load_demo_unet(str(tmp_path / "none"), 16, 32).cfg.model_channels == 64


@pytest.mark.parametrize("kw", [dict(), dict(num_channels=32, channel_mult="1,1,2,2")],
                         ids=["three-levels", "four-levels"])
def test_demo_unet_matches_jax(kw):
    """The converted JAX demo U-Net loads into the port's with the same
    state-dict keys (strict), the same attention levels and a bf16 torso;
    one forward within relative L2 0.02 of JAX's."""
    n_snap, latent = 16, 32
    jm = jdemo_common.build_demo_unet(n_snap, latent, **kw)
    params = perturbed(jax.tree.map(np.asarray, jm.init(jax.random.key(0))),
                       np.random.default_rng(1))
    tm = tdemo_common.build_demo_unet(n_snap, latent, **kw)
    sd = unet_state_dict_from_jax(params, tm)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    assert tm.cfg.torso_dtype == torch.bfloat16
    assert tm.cfg.attention_resolutions == jm.cfg.attention_resolutions
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, n_snap, latent)).astype(np.float32)
    ts = np.array([5, 800])
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                               jnp.asarray(ts)), np.float64)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(ts)).double().numpy()
    assert got.shape == want.shape == x.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= UNET_BF16_TOL, rel


def _tree(path):
    return {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
            for d, _, files in os.walk(path) for f in files}


def test_demo_runs_end_to_end_on_the_cpu(tmp_path):
    """``--fast --device cpu`` with 2 CNF epochs and 2 diffusion steps:
    every stage runs, the metrics are finite, the run directory holds the
    stage outputs, and nothing is written under ``examples/``."""
    before = _tree(os.path.join(REPO, "examples"))
    out = tmp_path / "demo"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "confild_tpu_torch.examples.demo_turbulence", "--fast",
         "--device", "cpu", "--cnf-epochs", "2", "--diff-steps", "2", "--out", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "demo_metrics.json") as f:
        m = json.load(f)
    gates = m["cnf_rmae"] + [m["cnf_recon_spectra_error"], m["spectra_relative_error"],
                             m["integral_timescale_real"], m["integral_timescale_generated"],
                             m["timescale_ratio"]]
    assert len(m["cnf_rmae"]) == 2 and all(np.isfinite(gates))
    assert m["config"]["backend"] == "cpu" and m["config"]["n_train_images"] == 4
    assert m["config"]["cnf_epochs"] == 2 and m["config"]["diff_steps"] == 2
    assert set(m["timing"]["stage_s"]) == {"simulate", "cnf", "diffusion", "sample", "decode",
                                           "metrics"}
    for name in ("fois.npy", "coords.npy", "cnf.yml", "sim_meta.json", "dckpt/unet.json",
                 "dckpt/model000002.pt", "dckpt/ema_0.999_000002.pt", "dckpt/data_max.npy",
                 "cnf_run/normalizer_params.pt", "cnf_run/checkpoint_1.pt",
                 "cnf_run/progress.csv"):
        assert (out / name).exists(), name
    assert _tree(os.path.join(REPO, "examples")) == before
    assert not os.path.exists(os.path.join(str(tmp_path), "demo_out_torch"))


def test_demo_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """Without ``--device cpu`` the demo resolves the card, and raises
    where there is none (before it writes anything)."""
    if torch.cuda.is_available():
        assert tdemo.parse_args([]).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdemo.main(["--fast", "--out", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
