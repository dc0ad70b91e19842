"""The port's generation and evaluation CLIs on the CPU against the JAX
package's: ``cli.sample`` (end to end, and its post-processing against the
JAX CLI's on the same latent image and the same CNF), ``cli.eval_cnf`` in
both modes with its argument checks, and ``cli.integral_timescale``, on
files the JAX package wrote."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from confild_tpu.cli import eval_cnf as jeval
from confild_tpu.cli import integral_timescale as jtau
from confild_tpu.cli import sample as jsample
from confild_tpu.cli import train_cnf as jtrain_cnf
from confild_tpu.diffusion import gaussian as jg
from confild_tpu.io.checkpoint import latest_checkpoint, save_pytree
from confild_tpu.models import unet as junet
from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.analysis import metrics
from confild_tpu_torch.cli import eval_cnf, integral_timescale, sample
from confild_tpu_torch.diffusion import gaussian as tg
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
from test_cnf_trainer import make_case
from torch_parity_utils import limit_torch_threads, perturbed

# the decode's f32 sums in other orders, amplified by w0 = 30 (as
# tests/test_torch_cli.py::test_cnf_inference_matches_jax)
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5
CLI_TOL = dict(rtol=1e-5, atol=1e-5)
LATENT = 16     # make_case's hidden_size
UNET = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="8", num_heads=2)
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.fixture(scope="module")
def cnf_run(tmp_path_factory):
    """A toy CNF trained for 2 epochs by the JAX package's CLI: its recipe,
    data, coordinates and newest ``.ckpt``."""
    root = tmp_path_factory.mktemp("cnf")
    make_case(root, epochs=2, save_every=1)
    jtrain_cnf.main([str(root / "case.yml")])
    ckpt, _ = latest_checkpoint(str(root / "run"))
    return root, ckpt


def _sample_recipe(root, cnf_root, **extra):
    jnet = junet.create_model(**UNET)
    params = perturbed(jax.tree.map(np.asarray, jnet.init(jax.random.key(0))),
                       np.random.default_rng(1), scale=0.02)
    save_pytree(str(root / "ema.ckpt"), params)
    np.save(root / "data_max.npy", np.float32(0.3))
    np.save(root / "data_min.npy", np.float32(-0.2))
    recipe = {**UNET, "num_head_channels": -1, "test_batch_size": 2, "time_length": LATENT,
              "latent_length": LATENT, "steps": 5, "noise_schedule": "cosine",
              "ema_path": str(root / "ema.ckpt"), "max_val": str(root / "data_max.npy"),
              "min_val": str(root / "data_min.npy"),
              "cnf_case_file_path": str(cnf_root / "case.yml"), "decode_batch_size": 8,
              "save_path": str(root / "generated.npy"), "seed": 3, "device": "cpu", **extra}
    path = root / "sample.yml"
    path.write_text(yaml.safe_dump(recipe))
    return recipe, str(path)


def test_sample_cli_cpu(cnf_run, tmp_path):
    """Generates finite fields of (B, T, M, C) whose decode is the CNF
    trainer's own of the returned latents; the same seed repeats them."""
    cnf_root, _ = cnf_run
    recipe, path = _sample_recipe(tmp_path, cnf_root)
    out = sample.main([path])
    fields = np.load(recipe["save_path"])
    assert fields.shape == (2, LATENT, 120, 2) and np.isfinite(fields).all()
    assert out["steps"] == 5 and out["latents"].shape == (2, LATENT, LATENT)
    assert out["sample_s"] > 0 and out["decode_s"] > 0
    lat = out["latents"]
    assert lat.min() >= -0.2 - 1e-6 and lat.max() <= 0.3 + 1e-6   # denormalized
    trainer = CNFTrainer(cfgmod.basic_input(recipe["cnf_case_file_path"]), device="cpu")
    trainer.load(-1, siren_only=True)
    for s in range(2):
        np.testing.assert_array_equal(
            fields[s], trainer.infer(trainer.train_coord, lat[s], batch=8).numpy())
    again = sample.main([path])
    np.testing.assert_array_equal(again["latents"], lat)
    assert not np.allclose(lat[0], lat[1])


def test_sample_cli_postprocessing_matches_jax(cnf_run, tmp_path, monkeypatch):
    """Given the same latent image from the loop, both CLIs denormalize and
    decode it through the same CNF to the same fields."""
    cnf_root, _ = cnf_run
    img = np.random.default_rng(4).uniform(-1, 1, (2, 1, LATENT, LATENT)).astype(np.float32)
    monkeypatch.setattr(jg.GaussianDiffusion, "p_sample_loop",
                        lambda self, model, shape, key, **kw: jnp.asarray(img))
    monkeypatch.setattr(tg.GaussianDiffusion, "p_sample_loop",
                        lambda self, model, shape, **kw: torch.from_numpy(img))
    recipe, path = _sample_recipe(tmp_path, cnf_root)
    out = sample.main([path])
    ours = np.load(recipe["save_path"])
    want_lat = (img[:, 0] + 1.0) * (0.3 - (-0.2)) / 2.0 + (-0.2)
    np.testing.assert_allclose(out["latents"], want_lat, rtol=1e-6, atol=1e-7)
    jax_recipe = dict(recipe, save_path=str(tmp_path / "jax.npy"))
    del jax_recipe["device"]
    jpath = tmp_path / "jax.yml"
    jpath.write_text(yaml.safe_dump(jax_recipe))
    jsample.main([str(jpath)])
    want = np.load(jax_recipe["save_path"])
    assert ours.shape == want.shape == (2, LATENT, 120, 2)
    np.testing.assert_allclose(ours, want, rtol=DECODE_RTOL, atol=DECODE_ATOL)


def test_sample_cli_refuses_bf16(cnf_run, tmp_path):
    """bf16, which ``cli.sample`` refused, samples now: a ``use_bf16``
    recipe generates and decodes finite fields of the f32 run's shape (the
    bf16 U-Net's numerics: tests/test_torch_bf16.py)."""
    recipe, path = _sample_recipe(tmp_path, cnf_run[0], use_bf16=True)
    out = sample.main([path])
    fields = np.load(recipe["save_path"])
    assert fields.shape == (2, LATENT, 120, 2) and np.all(np.isfinite(fields))
    assert out["steps"] == 5 and np.all(np.isfinite(out["latents"]))


def _eval_args(cnf_run, *extra):
    root, ckpt = cnf_run
    return ["--checkpoint", ckpt, "--config", str(root / "case.yml"),
            "--data", str(root / "fois.npy"), "--coords", str(root / "coords.npy"), *extra]


def _numbers(text):
    return np.array([float(x) for x in NUMBER.findall(text)])


def _both(capsys, jax_main, torch_main, args):
    """Run both CLIs on ``args``; their returns and printed numbers."""
    want = jax_main(args)
    jout = capsys.readouterr().out
    got = torch_main(args + ["--device", "cpu"] if torch_main is eval_cnf.main else args)
    tout = capsys.readouterr().out
    return want, got, jout, tout


@pytest.mark.parametrize("extra", [[], ["--num-snapshots", "5", "--batch-size", "3"]],
                         ids=["all", "five"])
def test_eval_cnf_full_set_matches_jax(cnf_run, capsys, extra):
    (wmse, wrmae), (mse, rmae), jout, tout = _both(capsys, jeval.main, eval_cnf.main,
                                                   _eval_args(cnf_run, *extra))
    assert mse.shape == rmae.shape == (2,) and np.isfinite(mse).all()
    np.testing.assert_allclose(mse, wmse, **CLI_TOL)
    np.testing.assert_allclose(rmae, wrmae, **CLI_TOL)
    assert jout.count("channel") == tout.count("channel") == 2
    np.testing.assert_allclose(_numbers(tout), _numbers(jout), **CLI_TOL)


@pytest.mark.parametrize("extra", [
    ["--timestep", "2", "--row", "0", "--vals", "5"],
    ["--timestep", "3", "--vals", "4", "--latent-indices", "1", "3", "7"],
], ids=["one-index", "indices"])
def test_eval_cnf_spot_check_matches_jax(cnf_run, capsys, extra):
    (wmse, wrmae), (mse, rmae), jout, tout = _both(capsys, jeval.main, eval_cnf.main,
                                                   _eval_args(cnf_run, *extra))
    assert mse.shape == (2,) and "TOTAL RMAE" in tout
    np.testing.assert_allclose(mse, wmse, **CLI_TOL)
    np.testing.assert_allclose(rmae, wrmae, **CLI_TOL)
    np.testing.assert_allclose(_numbers(tout), _numbers(jout), **CLI_TOL)


@pytest.mark.parametrize("extra,message", [
    (["--timestep", "2", "--latent-indices", "1", "3"], "not found in latent indices"),
    (["--timestep", "2", "--row", "-1"], "must be >= 0"),
    (["--timestep", "2", "--row", "1"], "out of range"),
])
def test_eval_cnf_argument_errors_match_jax(cnf_run, extra, message):
    args = _eval_args(cnf_run, *extra)
    with pytest.raises(ValueError, match=message) as want:
        jeval.main(args)
    with pytest.raises(ValueError, match=message) as got:
        eval_cnf.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def _ar_series(path, seed, n_t=300, space=(6, 6), rho=0.7):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_t, *space), np.float32)
    noise = rng.normal(size=(n_t, *space))
    for i in range(1, n_t):
        x[i] = rho * x[i - 1] + noise[i]
    np.save(path, x)
    return x


@pytest.mark.parametrize("extra", [[], ["--step-cutoff", "40"]], ids=["all", "cutoff"])
def test_integral_timescale_matches_jax(tmp_path, capsys, extra):
    x = _ar_series(tmp_path / "u.npy", 0)
    args = ["--output-dir", str(tmp_path / "u.npy"), "--output-dt", "0.1", *extra]
    want, got, jout, tout = _both(capsys, jtau.main, integral_timescale.main, args)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, **CLI_TOL)
    assert tout == jout
    cut = int(extra[1]) if extra else 0
    assert got == metrics.integral_timescale(x[cut:], 0.1)


def test_integral_timescale_components_and_plot(tmp_path, capsys):
    """(time, components, y, x) input picks ``--u-component``; ``--plot``
    writes the JAX CLI's figure."""
    u = _ar_series(tmp_path / "u.npy", 1, n_t=200, space=(2, 5, 5))
    args = ["--output-dir", str(tmp_path / "u.npy"), "--output-dt", "0.05",
            "--u-component", "1", "--plot", "--plot-dir", str(tmp_path)]
    want, got, jout, tout = _both(capsys, jtau.main, integral_timescale.main, args)
    np.testing.assert_allclose(got, want, **CLI_TOL)
    assert got == metrics.integral_timescale(u[:, 1], 0.05)
    assert os.path.exists(tmp_path / "autocorrelation_detailed_velocity.png")
    with pytest.raises(ValueError, match="more than 300 timesteps"):
        integral_timescale.main(["--output-dir", str(tmp_path / "u.npy"), "--output-dt",
                                 "0.1", "--step-cutoff", "300"])
