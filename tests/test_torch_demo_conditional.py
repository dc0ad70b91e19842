"""The port's held-out DPS experiment (``confild_tpu_torch/examples/
demo_conditional.py``) against the JAX script's (``examples/
demo_conditional.py``) on the CPU.

The JAX script's stages are closures inside its ``main()``, so each test
rebuilds the JAX side from the public ``confild_tpu`` calls the script
makes, step for step, on a tiny run directory the JAX package writes and
both packages read: the sensor indices and the sliced y-normalizer exactly,
the oracle fit against optax's Adam over the same cosine schedule, one DPS
ensemble fed the JAX members' own draws (float32 and the demo's bf16
U-Net), one noise-and-denoise round trip fed JAX's draws, and the port's
``main`` end to end: the JSON keys of the JAX script, writes only under
``--out``, and a card required unless asked for the CPU."""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from confild_tpu import config as jcfg
from confild_tpu.cli import train_cnf as jtrain_cnf
from confild_tpu.cli.sample import load_unet_params
from confild_tpu.core import normalize as jnorm
from confild_tpu.diffusion import create_gaussian_diffusion as j_diffusion
from confild_tpu.guidance import create_sampler as j_create_sampler
from confild_tpu.guidance import get_conditioning_method as j_method
from confild_tpu.guidance import get_noise as j_noise
from confild_tpu.guidance.operators import CNFDecodeOperator as JOperator
from confild_tpu.io.checkpoint import save_pytree
from confild_tpu.models import unet as junet
from confild_tpu.train.cnf_trainer import CNFTrainer as JTrainer
from confild_tpu_torch.diffusion import create_gaussian_diffusion as t_diffusion
from confild_tpu_torch.examples import demo_conditional as tcond
from confild_tpu_torch.io.convert import unet_state_dict_from_jax
from confild_tpu_torch.models import unet as tunet
from examples import demo_common as jdemo_common
from examples import demo_turbulence as jdemo
from torch_parity_utils import limit_torch_threads, perturbed, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "examples", "demo_conditional.py")
GRID, N_SNAP, N_TRAJ, LATENT = 16, 8, 2, 16
DEMO_UNET = dict(num_channels=32, channel_mult="1,2")
MX, MN = 0.4, -0.3
SEED = 777
# a float32 U-Net over the same latent images (the demo's is bf16)
F32_UNET = dict(image_size=max(N_SNAP, LATENT), num_channels=32, num_res_blocks=1,
                channel_mult="1,2", attention_resolutions="8", num_heads=2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)       # as tests/test_torch_guidance.py
UNET_BF16_TOL = 0.02                       # relative L2, as tests/test_torch_bf16.py
SAMPLE_TOL = dict(rtol=1e-5, atol=1e-5)    # as tests/test_torch_sample.py


@pytest.fixture(autouse=True, scope="module")
def _threads():
    limit_torch_threads()


def write_demo_run(root) -> None:
    """A tiny demo run directory written by the JAX package: the decaying
    flow on 16^2 (2 trajectories x 8 snapshots), a CNF (2 -> 32 x 3 -> 2,
    latent 16) trained 2 epochs by the JAX CLI, the demo U-Net's
    ``unet.json`` and a seeded JAX EMA (``.ckpt``), the latent scale and
    ``demo_metrics.json``.  The port reads every file of it."""
    root = str(root)
    fields = jdemo.simulate_turbulence(GRID, N_SNAP, N_TRAJ, **jdemo.FLOW_PRESETS["decaying"])
    np.save(os.path.join(root, "fois.npy"), fields.reshape(N_TRAJ * N_SNAP, GRID * GRID, 2))
    ax = np.linspace(0, 1, GRID)
    np.save(os.path.join(root, "coords.npy"),
            np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2).astype(np.float32))
    recipe = {"data_path": os.path.join(root, "fois.npy"),
              "coor_path": os.path.join(root, "coords.npy"),
              "save_path": os.path.join(root, "cnf_run"), "lumped_latent": True,
              "normalizer": {"method": "-11", "dim": 0}, "batch_size": 8,
              "test_batch_size": 8, "multiGPU": 1, "readin_data_shape": "t N c",
              "batch_shape": "t N c", "hidden_size": LATENT, "epochs": 2,
              "loss_fn": "MSELoss", "test_criteria": "rMAE", "save_every": 1, "dims": 2,
              "NF": {"name": "SIRENAutodecoder_film", "num_hidden_layers": 2,
                     "out_features": 2, "hidden_features": 32},
              "lr": {"nf": 1e-4, "latents": 1e-2}}
    with open(os.path.join(root, "cnf.yml"), "w") as f:
        yaml.safe_dump(recipe, f)
    jtrain_cnf.main([os.path.join(root, "cnf.yml")])
    dckpt = os.path.join(root, "dckpt")
    jdemo_common.save_demo_unet_config(dckpt, N_SNAP, LATENT, **DEMO_UNET)
    model = jdemo_common.build_demo_unet(N_SNAP, LATENT, **DEMO_UNET)
    params = perturbed(jax.tree.map(np.asarray, model.init(jax.random.key(0))),
                       np.random.default_rng(1), scale=0.02)
    save_pytree(os.path.join(dckpt, "ema_0.999_000002.ckpt"), params)
    np.save(os.path.join(dckpt, "data_max.npy"), np.float32(MX))
    np.save(os.path.join(dckpt, "data_min.npy"), np.float32(MN))
    with open(os.path.join(root, "demo_metrics.json"), "w") as f:
        json.dump({"config": {"n_traj": N_TRAJ, "n_snap": N_SNAP, "grid": GRID,
                              "latent": LATENT, "n_gen": 4, "sample_steps": 3,
                              "window": N_SNAP, "window_stride": 4,
                              "flow": "decaying"}}, f)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_run")
    write_demo_run(root)
    return str(root)


@pytest.fixture(scope="module")
def both(run_dir):
    """The JAX script's trainer (infer mode, as it loads it) and the
    port's assets on the CPU, from the same run directory."""
    jtr = JTrainer(jcfg.basic_input(os.path.join(run_dir, "cnf.yml")), infer_mode=True,
                   infer_dps=True)
    jtr.load(-1)
    return jtr, tcond.load_assets(run_dir, torch.device("cpu"))


@pytest.fixture(scope="module")
def held():
    fields = tcond.simulate_turbulence(GRID, N_SNAP, 2, seed=SEED,
                                       **tcond.FLOW_PRESETS["decaying"])
    return fields, fields.reshape(2, N_SNAP, GRID * GRID, 2)


def jax_dict_keys(path) -> dict:
    """The string keys of every dict literal in a script, by what holds
    it: the name it is assigned to (``report = {...}``, ``sweep[k] =
    {...}``), the list it is appended to, or its key in an enclosing dict."""
    found = {}

    def visit(name, node):
        found[name] = {k.value for k in node.keys if isinstance(k, ast.Constant)}
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Dict):
                visit(k.value, v)

    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            visit(target.id if isinstance(target, ast.Name) else target.value.id, node.value)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "append" and node.args
              and isinstance(node.args[0], ast.Dict)):
            visit(node.func.value.id, node.args[0])
    return found


def test_sensors_and_sliced_normalizer_are_exact(both, held):
    """The sensor indices, traces and sweep points from the same numpy
    draws, and the per-point y-normalizer sliced to them."""
    jtr, assets = both
    _, held_flat = held
    rng = np.random.default_rng(SEED + 1)
    want_idx = np.stack([rng.choice(GRID * GRID, size=5, replace=False) for _ in range(2)])
    want_meas = np.stack([held_flat[i, :, want_idx[i], :].transpose(1, 0, 2)
                          for i in range(2)])
    idx, meas = tcond.place_sensors(held_flat, 5, SEED)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(meas, want_meas)
    assert meas.shape == (2, N_SNAP, 5, 2)
    srng = np.random.default_rng(SEED + 2)
    for n, got in zip((1, 10, 100), tcond.sweep_indices(GRID, (1, 10, 100), SEED)):
        np.testing.assert_array_equal(got, np.sort(srng.choice(GRID * GRID, n, replace=False)))
    assert np.asarray(jtr.out_normalizer.params[0]).ndim == 3
    for point_idx in (idx[0], None):
        want = tuple(np.asarray(p) if point_idx is None else np.asarray(p)[:, point_idx, :]
                     for p in jtr.out_normalizer.params)
        got = tcond.ynorm_sliced(assets.tr.out_normalizer, point_idx)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_fit_oracle_matches_optax(both, held):
    """50 steps of latent-only Adam at ``cosine_decay_schedule(1e-2, 50,
    alpha=1e-2)`` through the plain decode, as the JAX script's
    ``fit_segment`` (one scan here): the latents within a relative L2 of
    1e-4, the losses of steps 25 and 50 within 1e-4."""
    jtr, assets = both
    _, held_flat = held
    n_fit = 50
    xn = jtr.in_normalizer.as_jax().normalize(jnp.asarray(assets.full_coords))
    yn = jtr.out_normalizer.as_jax().normalize(jnp.asarray(held_flat[0]))
    opt = optax.adam(optax.cosine_decay_schedule(1e-2, n_fit, alpha=1e-2))
    nf_params = jtr.state.nf_params

    def loss_fn(z):
        return jnp.mean((jtr.model(nf_params, xn, z[:, None, :]) - yn) ** 2)

    def step(carry, _):
        z, ost = carry
        loss, g = jax.value_and_grad(loss_fn)(z)
        up, ost = opt.update(g, ost, z)
        return (optax.apply_updates(z, up), ost), loss

    z0 = jnp.zeros((N_SNAP, LATENT), jnp.float32)
    (want_z, _), losses = jax.lax.scan(step, (z0, opt.init(z0)), length=n_fit)
    z, loss_end, loss_mid = tcond.fit_oracle(assets, held_flat[0], n_fit)
    want_z = np.asarray(want_z)
    rel = np.linalg.norm(z.numpy() - want_z) / np.linalg.norm(want_z)
    assert rel <= 1e-4, rel
    np.testing.assert_allclose([loss_mid, loss_end],
                               np.asarray(losses)[[n_fit // 2 - 1, n_fit - 1]], rtol=1e-4)
    assert loss_end < loss_mid


def _jax_ensemble(jtr, jmodel, jparams, coords, yn_params, y, scale, steps, n_ens, seed):
    """The JAX script's ``run_ensemble``: ``run_one`` vmapped over the
    members' keys and initial images."""
    sampler = j_create_sampler(sampler="ddpm", steps=1000, noise_schedule="cosine",
                               timestep_respacing=str(steps))
    op = JOperator(params=jtr.state.nf_params, coords=jnp.asarray(coords, jnp.float32),
                   x_normalizer=jtr.in_normalizer,
                   y_normalizer=jnorm.Normalizer(tuple(jnp.asarray(p) for p in yn_params),
                                                 jtr.out_normalizer.method,
                                                 jtr.out_normalizer.dim),
                   max_val=MX, min_val=MN)
    cond = j_method("ps", op, j_noise("clean"), scale=scale)

    def run_one(x_start, k):
        return sampler.p_sample_loop(lambda x, tm, **kw: jmodel.apply(jparams, x, tm),
                                     x_start, jnp.asarray(y), cond, k,
                                     return_distances=True)

    keys = jax.random.split(jax.random.key(seed), n_ens)
    x_starts = jax.random.normal(jax.random.key(seed + 1), (n_ens, 1, 1, N_SNAP, LATENT))
    samples, dists = jax.jit(jax.vmap(run_one))(x_starts, keys)
    return keys, np.asarray(x_starts), np.asarray(samples)[:, 0, 0], np.asarray(dists)[:, -1]


def _fed_ensemble(assets, keys, x_starts, coords, yn_params, y, scale, steps, n_ens, seed):
    """The port's ``run_ensemble`` fed the JAX members' draws: step i's
    sample noise ``normal(fold_in(key_s, i))`` for member s."""
    def noise_fn(i):
        eps = np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(k, i),
                                                           (1, 1, N_SNAP, LATENT)))
                              for k in keys])
        return t(eps), None, None
    return tcond.run_ensemble(assets, coords, yn_params, y, scale, steps, n_ens, seed,
                              x_start=t(x_starts[:, 0]), noise_fn=noise_fn)


def _f32_unets():
    jnet = junet.create_model(**F32_UNET)
    params = perturbed(jax.tree.map(np.asarray, jnet.init(jax.random.key(3))),
                       np.random.default_rng(4), scale=0.02)
    tnet = tunet.create_model(**F32_UNET)
    tnet.load_state_dict(unet_state_dict_from_jax(params, tnet))
    return jnet, jax.tree.map(jnp.asarray, params), tnet.eval().requires_grad_(False)


@pytest.mark.parametrize("unet", ["float32", "demo bf16"])
def test_run_ensemble_matches_jax(both, held, run_dir, unet):
    """One guided DDPM run of 3 respaced steps, 2 members as one batch,
    fed the JAX members' draws: float32 U-Net within 1e-4 (samples and
    final misfits); the demo's bf16 U-Net (the EMA of the run directory)
    within a relative L2 of 0.02."""
    jtr, assets = both
    _, held_flat = held
    idx, meas = tcond.place_sensors(held_flat, 6, SEED)
    coords = assets.full_coords[idx[0]]
    yn = tcond.ynorm_sliced(assets.tr.out_normalizer, idx[0])
    if unet == "float32":
        jmodel, jparams, tnet = _f32_unets()
        assets = dataclasses.replace(assets, unet=tnet)
    else:
        jmodel = jdemo_common.load_demo_unet(os.path.join(run_dir, "dckpt"), N_SNAP, LATENT)
        jparams = load_unet_params(os.path.join(run_dir, "dckpt", "ema_0.999_000002.ckpt"),
                                   jmodel)
    keys, x_starts, want, want_d = _jax_ensemble(jtr, jmodel, jparams, coords, yn, meas[0],
                                                 1.0, 3, 2, 10)
    got, got_d, step_ms = _fed_ensemble(assets, keys, x_starts, coords, yn, meas[0], 1.0, 3,
                                        2, 10)
    assert got.shape == want.shape == (2, N_SNAP, LATENT) and step_ms > 0
    if unet == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        np.testing.assert_allclose(got_d, want_d, **F32_TOL)
    else:
        for a, b in ((got, want), (got_d, want_d)):
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= UNET_BF16_TOL, rel
    # the members are guided independently
    assert not np.allclose(got_d[0], got_d[1])


def test_roundtrip_matches_jax(both):
    """Noise the latent image to t* = 3 of 5 respaced steps and denoise
    it, fed JAX's draws (``normal(key)`` for the noise, ``normal(fold_in(key,
    i))`` for step i): the JAX script's scan, which runs every step and
    freezes those at or above t*, within 1e-5."""
    _, assets = both
    jnet, jparams, tnet = _f32_unets()
    assets = dataclasses.replace(assets, unet=tnet)
    jd = j_diffusion(steps=1000, noise_schedule="cosine", timestep_respacing="5")
    td = t_diffusion(steps=1000, noise_schedule="cosine", timestep_respacing="5")
    x0 = np.tanh(np.random.default_rng(5).standard_normal((1, 1, N_SNAP, LATENT))).astype(
        np.float32)
    key, t_star = jax.random.key(50), 3

    @jax.jit
    def roundtrip(x0):
        xt = jd.q_sample(x0, jnp.full((1,), t_star, jnp.int32),
                         jax.random.normal(key, x0.shape, x0.dtype))

        def step(img, i):
            out = jd.p_sample(lambda x, tm, **kw: jnet.apply(jparams, x, tm), img,
                              jnp.full((1,), i, jnp.int32), jax.random.fold_in(key, i))
            return jnp.where(i < t_star, out["sample"], img), None
        return jax.lax.scan(step, xt, jnp.arange(jd.num_timesteps - 1, -1, -1))[0]

    want = np.asarray(roundtrip(jnp.asarray(x0)))
    got = tcond.roundtrip(
        assets, td, t(x0), t_star, noise=t(jax.random.normal(key, x0.shape)),
        step_noise=lambda i: t(jax.random.normal(jax.random.fold_in(key, i), x0.shape)))
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)
    assert not np.allclose(want, x0)


def _tree(path):
    return {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
            for d, _, files in os.walk(path) for f in files}


def test_main_end_to_end_on_the_cpu(run_dir, tmp_path, monkeypatch):
    """The whole protocol at ``--device cpu`` (2 trajectories, 2 members,
    3 steps, the prior check on, a sweep at 4 and 64 sensors): every
    number finite, the JSON keys the JAX script's (and ``device``), and
    nothing written outside ``--out``."""
    before = [_tree(os.path.join(REPO, d)) for d in ("examples", "demo_out_torch")]
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    rep = tcond.main(["--device", "cpu", "--out", run_dir, "--n-held", "2", "--n-sensors",
                      "5", "--n-ens", "2", "--steps", "3", "--scales", "0.3,1.0",
                      "--sensor-sweep", "4,64"])
    with open(os.path.join(run_dir, "demo_conditional.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    keys = jax_dict_keys(JAX_SCRIPT)
    assert set(rep) == keys["report"] | {"device"}
    assert set(rep["protocol"]) == keys["protocol"]
    assert set(rep["protocol"]["tuning_sweep"]) == {"ps@0.3", "ps@1.0", "ps_linear_decay@1.0"}
    assert all(set(v) == keys["sweep"] for v in rep["protocol"]["tuning_sweep"].values())
    assert [set(r) for r in rep["per_trajectory"]] == [keys["per_traj"]] * 2
    assert [r["n_sensors"] for r in rep["sensor_sweep"]] == [4, 64]
    assert all(set(r) == keys["sensor_sweep"] for r in rep["sensor_sweep"])
    cov = rep["prior_coverage"]
    assert set(cov) == keys["prior_coverage"]
    assert [set(r) for r in cov["oracle_fit_convergence"]] == [keys["fit_conv"]] * 2
    assert len(cov["roundtrip"]) == 6 and all(set(r) == keys["rt_rows"] for r in cov["roundtrip"])
    assert set(rep["in_distribution_control"]) == keys["in_dist"]
    assert rep["device"]["kind"] == "cpu"
    numbers = [rep[k] for k in ("sensor_rmae_pooled", "sigma3_coverage_pooled",
                                "field_rmae_held_out", "conditioning_gain",
                                "spectra_relative_error", "timescale_ratio")]
    numbers += [v for r in rep["sensor_sweep"] for v in r.values()]
    numbers += [r["field_rmae_vs_truth"] for r in cov["roundtrip"]]
    assert np.all(np.isfinite(numbers))
    assert os.listdir(cwd) == []
    assert [_tree(os.path.join(REPO, d)) for d in ("examples", "demo_out_torch")] == before


def test_main_needs_a_card_unless_asked_for_the_cpu(run_dir):
    if torch.cuda.is_available():
        assert tcond.parse_args([]).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcond.main(["--out", run_dir])


def test_main_refuses_a_run_dir_without_its_metrics(tmp_path):
    with pytest.raises(SystemExit, match="demo_metrics.json missing"):
        tcond.main(["--device", "cpu", "--out", str(tmp_path)])
