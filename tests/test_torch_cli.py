"""The port's entry points on the CPU: the conditional-generation CLI from
reference ``.pt`` and JAX-package ``.ckpt`` assets, ``CNF_inference``
against the JAX package, the import boundary, and the refusal to run on the
CPU unless asked."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from confild_tpu.inference import CNF_inference as JInference
from confild_tpu.io import torch_export
from confild_tpu.io.checkpoint import save_pytree
from confild_tpu.models import unet as junet
from confild_tpu_torch.cli import sample_conditional
from confild_tpu_torch.core.normalize import Normalizer
from confild_tpu_torch.inference import CNF_inference, decoder
from torch_parity_utils import jax_siren, limit_torch_threads, perturbed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = dict(image_size=8, num_channels=32, num_res_blocks=1, channel_mult="1,2",
            attention_resolutions="4", num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def _write_assets(tmp_path, fmt):
    """Toy Case4-style assets written by the JAX package's own writers."""
    rng = np.random.default_rng(0)
    jnet = junet.create_model(**UNET)
    uparams = perturbed(jax.tree.map(np.asarray, jnet.init(jax.random.key(0))),
                        np.random.default_rng(1), scale=0.02)
    cparams, _ = jax_siren(c_in=2, latent=8, c_out=1, layers=1, hidden=32)
    latents = (0.1 * rng.standard_normal((4, 8))).astype(np.float32)
    x_par = (np.ones(2, np.float32), np.zeros(2, np.float32))
    y_par = (np.ones((1, 1), np.float32), -np.ones((1, 1), np.float32))
    d = tmp_path / fmt
    d.mkdir()
    if fmt == "pt":
        torch_export.save_unet_checkpoint_pt(str(d / "ema.pt"), uparams, jnet)
        torch_export.save_cnf_checkpoint_pt(str(d / "cnf.pt"), cparams, latents)
        torch_export.save_normalizer_params_pt(str(d / "norm.pt"), x_par, y_par)
    else:
        save_pytree(str(d / "ema.ckpt"), uparams)
        save_pytree(str(d / "cnf.ckpt"), {"model_state_dict": cparams,
                                          "hidden_states": {"latents": latents}})
        save_pytree(str(d / "norm.ckpt"), {"x_normalizer_params": x_par,
                                           "y_normalizer_params": y_par})
    coords = np.random.default_rng(2).uniform(size=(60, 2)).astype(np.float32)
    np.save(tmp_path / "coords.npy", coords)
    np.save(tmp_path / "sensor_coords.npy", coords[:5])
    np.save(tmp_path / "measures.npy", np.zeros((8, 5, 1), np.float32))
    np.save(tmp_path / "data_max.npy", np.float32(1.0))
    np.save(tmp_path / "data_min.npy", np.float32(-1.0))
    return {
        **UNET, "num_head_channels": -1, "steps": 4, "noise_schedule": "cosine",
        "ema_path": str(d / f"ema.{fmt}"), "cnf_checkpoint": str(d / f"cnf.{fmt}"),
        "cnf_normalizer": str(d / f"norm.{fmt}"), "cnf_coords": str(tmp_path / "coords.npy"),
        "data_max": str(tmp_path / "data_max.npy"), "data_min": str(tmp_path / "data_min.npy"),
        "sensor_coords": str(tmp_path / "sensor_coords.npy"),
        "sensor_measures": str(tmp_path / "measures.npy"),
        "operator": "case4", "sampler": "ddpm", "conditioning": "ps", "scale": 0.1,
        "noise": "gaussian", "noise_sigma": 0.05, "no_of_samples": 2, "time_length": 8,
        "latent_size": 8, "decode_batch_size": 4, "seed": 0,
        "save_path": str(tmp_path / f"out_{fmt}.npy"), "device": "cpu",
    }


def _run(tmp_path, recipe):
    path = tmp_path / "cond.yml"
    path.write_text(yaml.safe_dump(recipe))
    return sample_conditional.main([str(path)])


def test_sample_conditional_cpu_from_pt_and_ckpt(tmp_path):
    """The same weights as reference .pt files and as JAX .ckpt pytrees give
    the same conditional samples."""
    outs = {}
    for fmt in ("pt", "ckpt"):
        recipe = _write_assets(tmp_path, fmt)
        timings = _run(tmp_path, recipe)
        outs[fmt] = np.load(recipe["save_path"])
        assert outs[fmt].shape == (2, 8, 60, 1)
        assert np.all(np.isfinite(outs[fmt]))
        assert timings["steps"] == 4
    np.testing.assert_array_equal(outs["pt"], outs["ckpt"])
    assert not np.allclose(outs["pt"][0], outs["pt"][1])    # independent samples


def test_bf16_torso_is_not_ported(tmp_path):
    recipe = _write_assets(tmp_path, "ckpt")
    recipe["use_bf16"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(tmp_path, recipe)


def test_cnf_inference_matches_jax(tmp_path):
    cparams, _ = jax_siren(c_in=2, latent=8, c_out=2, layers=2, hidden=32)
    latents = (0.1 * np.random.default_rng(3).standard_normal((6, 8))).astype(np.float32)
    save_pytree(str(tmp_path / "checkpoint_1.ckpt"),
                {"model_state_dict": cparams, "hidden_states": {"latents": latents}})
    save_pytree(str(tmp_path / "normalizer_params.ckpt"),
                {"x_normalizer_params": (np.ones(2, np.float32), np.zeros(2, np.float32)),
                 "y_normalizer_params": (np.full((1, 2), 2.0, np.float32),
                                         np.full((1, 2), -1.0, np.float32))})
    (tmp_path / "cnf.yml").write_text(yaml.safe_dump({
        "dims": 2, "hidden_size": 8,
        "NF": {"name": "SIRENAutodecoder_film", "out_features": 2,
               "num_hidden_layers": 2, "hidden_features": 32}}))
    args = (str(tmp_path / "checkpoint_1.ckpt"), str(tmp_path / "cnf.yml"))
    ours = CNF_inference(*args, device="cpu")
    ref = JInference(*args, use_pallas=False)
    grid = ours.create_coordinates_grid((5, 4)).reshape(-1, 2)
    got = ours.predict(grid, [1, 4, 5], batch_size=2)
    want = np.asarray(ref.predict(grid, [1, 4, 5], batch_size=2))
    assert got.shape == want.shape == (3, 20, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_port_imports_neither_jax_nor_confild_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import confild_tpu_torch\n"
        "for m in pkgutil.walk_packages(confild_tpu_torch.__path__, 'confild_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'confild_tpu' or k.startswith('confild_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_refuse_cpu_unless_asked(tmp_path, monkeypatch):
    """Without a card and without device='cpu' the entry points raise; they
    never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, model = jax_siren(c_in=2, latent=8, c_out=1, layers=1, hidden=32)
    x_norm = Normalizer((np.ones(2, np.float32), np.zeros(2, np.float32)), "-11", 0)
    y_norm = Normalizer((np.ones((1, 1), np.float32), -np.ones((1, 1), np.float32)), "-11", 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decoder(np.zeros((4, 2), np.float32), np.zeros((2, 8), np.float32), model,
                x_norm, y_norm)
    recipe = _write_assets(tmp_path, "ckpt")
    del recipe["device"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(tmp_path, recipe)
    out = decoder(np.zeros((4, 2), np.float32), np.zeros((2, 8), np.float32), model,
                  x_norm, y_norm, device="cpu")
    assert out.shape == (2, 4, 1)
