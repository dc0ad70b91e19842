"""The port's quality report (``confild_tpu_torch/examples/demo_report.py``)
against the JAX script's (``examples/demo_report.py``) on the CPU, on the
tiny JAX-written run directory of ``test_torch_demo_conditional.py``: the
CNF reconstruction, the regenerated ensemble fed the JAX script's draws
(one ``split`` of the batch key into noise and loop keys, ``fold_in`` of
the loop key per step), the metrics with their bootstrap intervals from
identical fields, and the port's ``main`` end to end."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confild_tpu import config as jcfg
from confild_tpu.analysis import metrics as jm
from confild_tpu.diffusion import create_gaussian_diffusion as j_diffusion
from confild_tpu.train.cnf_trainer import CNFTrainer as JTrainer
from confild_tpu_torch import config as tcfg
from confild_tpu_torch.diffusion import create_gaussian_diffusion as t_diffusion
from confild_tpu_torch.examples import demo_report as treport
from confild_tpu_torch.train.cnf_trainer import CNFTrainer as TTrainer
from examples import demo_turbulence as jdemo
from test_torch_demo_conditional import (GRID, LATENT, N_SNAP, N_TRAJ, REPO, _f32_unets,
                                         _tree, jax_dict_keys, write_demo_run)
from torch_parity_utils import limit_torch_threads, t

JAX_SCRIPT = os.path.join(REPO, "examples", "demo_report.py")
# the decode's f32 sums in other orders, amplified by w0 = 30 (as
# tests/test_torch_eval_cli.py)
DECODE_TOL = dict(rtol=1e-4, atol=1e-5)
SAMPLE_TOL = dict(rtol=1e-5, atol=1e-5)    # as tests/test_torch_sample.py
METRIC_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_run")
    write_demo_run(root)
    return str(root)


def test_reconstruction_matches_jax(run_dir):
    """The first 2 * n_snap latent rows decoded on the training mesh, by
    the JAX script's trainer (full mode, as it loads it) and the port's."""
    path = os.path.join(run_dir, "cnf.yml")
    jtr = JTrainer(jcfg.basic_input(path))
    jtr.load(-1)
    ttr = TTrainer(tcfg.basic_input(path), device="cpu")
    ttr.load(-1)
    n_eval = min(2 * N_SNAP, N_TRAJ * N_SNAP)
    want = np.asarray(jtr.infer(jtr.train_coord, jtr.state.latents[:n_eval]))
    got = treport.reconstruct(ttr, n_eval)
    assert got.shape == want.shape == (n_eval, GRID * GRID, 2)
    np.testing.assert_allclose(got, want, **DECODE_TOL)


def test_regenerate_matches_jax():
    """3 members in one batch over 4 respaced steps, the port fed the JAX
    script's draws for batch key ``key(100 + b)``: within 1e-5."""
    jnet, jparams, tnet = _f32_unets()
    jd = j_diffusion(steps=1000, noise_schedule="cosine", timestep_respacing="4")
    td = t_diffusion(steps=1000, noise_schedule="cosine", timestep_respacing="4")
    shape = (3, 1, N_SNAP, LATENT)

    @jax.jit
    def step(img, i, loop_key):
        return jd.p_sample(lambda x, tm, **kw: jnet.apply(jparams, x, tm), img,
                           jnp.full((img.shape[0],), i, jnp.int32),
                           jax.random.fold_in(loop_key, i))["sample"]

    noise_key, loop_key = jax.random.split(jax.random.key(100))
    img = jax.random.normal(noise_key, shape, jnp.float32)
    for i in range(jd.num_timesteps - 1, -1, -1):
        img = step(img, i, loop_key)
    want = np.asarray(img)[:, 0]

    def draws(b):
        nk, lk = jax.random.split(jax.random.key(100 + b))
        return (t(jax.random.normal(nk, shape, jnp.float32)),
                lambda i: t(jax.random.normal(jax.random.fold_in(lk, i), shape, jnp.float32)))
    got = treport.regenerate(tnet, td, 3, N_SNAP, LATENT, torch.device("cpu"), draws=draws)
    assert got.shape == want.shape == (3, N_SNAP, LATENT)
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)


def _jax_metrics(fields, real_wins, gen_grid, recon_grid, real_eval):
    """The JAX script's metric lines (``demo_report.py:191-225, 276-304``)
    on the JAX package's ``analysis.metrics``."""
    n_gen, grid = gen_grid.shape[0], fields.shape[2]
    spec_err = jm.spectra_relative_error(
        np.concatenate([gen_grid[..., 0], gen_grid[..., 1]]).reshape(-1, grid),
        np.concatenate([fields[..., 0], fields[..., 1]]).reshape(-1, grid), axis=-1)
    recon_spec_err = jm.spectra_relative_error(recon_grid[..., 0].reshape(-1, grid),
                                               real_eval[..., 0].reshape(-1, grid), axis=-1)
    tau_real = float(np.mean([jm.integral_timescale(real_wins[i, ..., 0], 1.0)
                              for i in range(real_wins.shape[0])]))
    per_member_tau = np.array([jm.integral_timescale(gen_grid[i, ..., 0], 1.0)
                               for i in range(n_gen)])
    tau_gen = float(per_member_tau.mean())
    member_spec = np.stack([jm.energy_spectrum_1d(np.concatenate(
        [gen_grid[s, ..., 0], gen_grid[s, ..., 1]]).reshape(-1, grid))[1]
        for s in range(n_gen)])
    _, e_real_full = jm.energy_spectrum_1d(np.concatenate(
        [fields[..., 0], fields[..., 1]]).reshape(-1, grid))
    rng = np.random.default_rng(0)
    boot_spec, boot_tau = [], []
    for _ in range(500):
        idx = rng.integers(0, n_gen, n_gen)
        e_b = member_spec[idx].mean(axis=0)
        boot_spec.append(float(np.linalg.norm(e_b - e_real_full)
                               / np.linalg.norm(e_real_full)))
        boot_tau.append(float(per_member_tau[idx].mean()) / tau_real)
    r_real = jm.two_point_correlation(fields[..., 0].reshape(-1, grid))
    r_gen = jm.two_point_correlation(gen_grid[..., 0].reshape(-1, grid))
    return {
        "cnf_recon_spectra_error": float(recon_spec_err),
        "spectra_relative_error": float(spec_err),
        "integral_timescale_real": tau_real,
        "integral_timescale_generated": tau_gen,
        "timescale_ratio": tau_gen / tau_real,
        "spectra_error_ci95": [float(np.percentile(boot_spec, q)) for q in (2.5, 97.5)],
        "timescale_ratio_ci95": [float(np.percentile(boot_tau, q)) for q in (2.5, 97.5)],
        "velocity_pdf_js_divergence": {
            "u": jm.pdf_jensen_shannon(gen_grid[..., 0], fields[..., 0]),
            "v": jm.pdf_jensen_shannon(gen_grid[..., 1], fields[..., 1])},
        "two_point_correlation_error": float(np.linalg.norm(r_gen - r_real)
                                             / np.linalg.norm(r_real)),
        "bootstrap_resamples": 500,
    }


def test_report_metrics_match_jax():
    """Every number of the report, the bootstrap intervals included, from
    the same fields: 3 simulated trajectories of 16 snapshots windowed by
    8 (stride 4), 5 generated windows, a perturbed reconstruction."""
    with np.errstate(all="ignore"):
        fields = jdemo.simulate_turbulence(16, 16, 3, **jdemo.FLOW_PRESETS["decaying"])
        gen_grid = jdemo.simulate_turbulence(16, 8, 5, seed=9,
                                             **jdemo.FLOW_PRESETS["decaying"])
    real_wins = treport.sliding_windows(fields, 8, 4)
    real_eval = fields.reshape(-1, 16, 16, 2)[:16]
    recon_grid = real_eval + 0.01 * np.random.default_rng(3).standard_normal(
        real_eval.shape).astype(np.float32)
    want = _jax_metrics(fields, real_wins, gen_grid, recon_grid, real_eval)
    got = treport.report_metrics(fields, real_wins, gen_grid, recon_grid, real_eval)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v)
            np.testing.assert_allclose([got[k][c] for c in v], list(v.values()),
                                       rtol=METRIC_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, err_msg=k)
    assert want["spectra_error_ci95"][0] < want["spectra_error_ci95"][1]


def test_main_end_to_end_on_the_cpu(run_dir, tmp_path, monkeypatch):
    """``--n-gen 2 --sample-steps 3 --device cpu``: finite numbers, the JSON
    keys the JAX script's (and ``device``), the plots and the report in the
    run directory and nothing written anywhere else."""
    before = [_tree(os.path.join(REPO, d)) for d in ("examples", "demo_out_torch")]
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    files_before = set(os.listdir(run_dir))
    rep = treport.main(["--device", "cpu", "--out", run_dir, "--n-gen", "2",
                        "--sample-steps", "3"])
    with open(os.path.join(run_dir, "demo_report.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    keys = jax_dict_keys(JAX_SCRIPT)
    assert set(rep) == keys["report"] | {"device"}
    assert set(rep["velocity_pdf_js_divergence"]) == keys["pdf_js"]
    assert rep["n_gen"] == 2 and rep["sample_steps"] == 3 and rep["device"]["kind"] == "cpu"
    numbers = rep["cnf_rmae"] + rep["spectra_error_ci95"] + rep["timescale_ratio_ci95"] + [
        rep[k] for k in ("cnf_recon_spectra_error", "spectra_relative_error",
                         "timescale_ratio", "two_point_correlation_error")]
    assert len(rep["cnf_rmae"]) == 2 and np.all(np.isfinite(numbers))
    written = set(os.listdir(run_dir)) - files_before
    try:
        import matplotlib  # noqa: F401
        plots = {f"demo_{n}.png" for n in ("spectra", "autocorr", "pdf", "two_point",
                                           "snapshots")}
    except ImportError:
        plots = set()
    assert written <= {"demo_report.json"} | plots
    assert plots <= set(os.listdir(run_dir))
    assert os.listdir(cwd) == []
    assert [_tree(os.path.join(REPO, d)) for d in ("examples", "demo_out_torch")] == before


def test_main_needs_a_card_unless_asked_for_the_cpu(run_dir):
    if torch.cuda.is_available():
        assert treport.parse_args([]).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treport.main(["--out", run_dir])


def test_main_refuses_fields_of_another_run(run_dir, tmp_path):
    """A ``demo_metrics.json`` that does not describe the directory's
    ``fois.npy`` is refused before anything loads."""
    shutil.copy(os.path.join(run_dir, "fois.npy"), tmp_path / "fois.npy")
    with open(os.path.join(run_dir, "demo_metrics.json")) as f:
        m = json.load(f)
    m["config"]["n_traj"] = N_TRAJ + 1
    (tmp_path / "demo_metrics.json").write_text(json.dumps(m))
    with pytest.raises(SystemExit, match="does not belong to this run dir"):
        treport.main(["--device", "cpu", "--out", str(tmp_path)])
