"""Diffusion training loop, the port of ``confild_tpu/train/diffusion_trainer.py``
(reference ``UnconditionalDiffusionTraining_and_Generation/src/train_util.py``
``TrainLoop``).

Reproduced semantics:

* AdamW with the linear lr anneal over ``lr_anneal_steps`` (optax's
  ``linear_schedule``: the lr of an update is ``lr * (1 - count / N)``,
  ``count`` the updates applied so far), ``lr_anneal_steps`` counted as
  total steps (a resume continues towards the same horizon);
* an EMA of the parameters per rate, updated after every step;
* microbatch gradient accumulation, the noise drawn for the whole batch
  first so that microbatched and full-batch steps agree;
* the non-finite-gradient guard: a step whose gradient norm is not finite
  leaves the parameters and the optimizer state as they were;
* a validation forward after every step (``valid_mse``), per-quartile
  losses bucketed by t, ``grad_norm``, ``param_norm``,
  ``skipped_nonfinite``;
* a bf16 U-Net torso (``use_bf16``) trains on float32 parameters,
  gradients, EMA and AdamW state (its convolutions cast their weights at
  use), with no loss scaling, as the JAX loop does;
* ``model/ema_{rate}/opt{step:06d}.pt`` triplets, filename-based resume
  (from the port's ``.pt`` triplet or the JAX package's ``.ckpt`` one), the
  ``DIFFUSION_TRAINING_TEST`` early exit;
* ``steps_per_call`` steps a call (:meth:`TrainLoop.run_steps`: the JAX
  loop's multi-step scan, here a Python loop of steps) logged as the mean
  of each metric's finite values over the call, and ``device_data``: a
  training array resident on the device, each step's batch gathered there
  with indices drawn on the device (no host-to-device batch copies).

The random draws (``t``, the importance weights, the noise) are kept apart
from the step arithmetic: :meth:`TrainLoop.train_step` and
:meth:`TrainLoop.valid_step` take them as tensors, so a test can feed the
port the numbers the JAX step drew.  The U-Net runs without dropout in
training, as the JAX step (which passes no dropout key) does.

Data parallelism (``mesh``, a :class:`~confild_tpu_torch.parallel.mesh.
DataMesh`): every rank takes the *global* batch and the global batch's
draws, from generators seeded alike on every rank, and keeps its own
contiguous slice, so that a step equals the single-process step on the same
batch.  The U-Net trains under DDP (gradients averaged over the mesh once a
step; microbatches before the last run under ``no_sync``); the EMA and the
checkpoints hold the unwrapped module's parameters.  The per-sample losses
are gathered, so the logged metrics and the timestep sampler's state are
the global batch's on every rank.  Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import numpy as np
import torch

from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.diffusion.gaussian import GaussianDiffusion
from confild_tpu_torch.diffusion.resample import UniformSampler
from confild_tpu_torch.io import checkpoint as ckpt_io
from confild_tpu_torch.io import convert
from confild_tpu_torch.models import nn as tnn
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.utils import logger as tlog


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def _to_cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


class TrainLoop:
    """``run_loop()`` trains ``model`` (its current weights are the start
    unless ``resume_checkpoint`` names a triplet) on batches from ``data``
    on ``device`` (default: the CUDA card; the CPU only when asked), data
    parallel over ``mesh`` when one is given."""

    def __init__(self, *, model, diffusion: GaussianDiffusion, data: Iterator,
                 batch_size: int, microbatch: int = -1, lr: float = 1e-4,
                 ema_rate: str | float = "0.9999", log_interval: int = 10,
                 save_interval: int = 10000, resume_checkpoint: str = "",
                 weight_decay: float = 0.0, lr_anneal_steps: int = 0,
                 valid_data: Iterator | None = None, schedule_sampler=None,
                 save_dir: str | None = None, mesh=None, seed: int = 42,
                 steps_per_call: int = 1, keep_checkpoints: int = 0, device_data=None,
                 device=None):
        if device_data is not None and valid_data is not None:
            raise ValueError("device_data does not support valid_data")
        if mesh is not None and not isinstance(mesh, pmesh.DataMesh):
            raise TypeError(f"mesh must be a DataMesh (parallel.mesh.get_mesh), "
                            f"not {type(mesh).__name__}")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.diffusion = diffusion
        self.data = data
        self.valid_data = valid_data
        self.batch_size = batch_size
        self.microbatch = microbatch if microbatch > 0 else batch_size
        self.lr = lr
        self.ema_rate = ([ema_rate] if isinstance(ema_rate, float)
                         else [float(x) for x in str(ema_rate).split(",")])
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.resume_checkpoint = resume_checkpoint
        self.lr_anneal_steps = lr_anneal_steps
        self.sampler = schedule_sampler or UniformSampler(diffusion.num_timesteps)
        self.save_dir = save_dir or (tlog.get_current().dir or ".")
        self.keep_checkpoints = keep_checkpoints
        # t and the importance weights are drawn on the host (the schedule
        # tables live there), the noise on the device
        self.generator = torch.Generator().manual_seed(seed)
        self.noise_generator = torch.Generator(self.device).manual_seed(seed + 1)
        # several steps a call; 1 keeps one step per run_loop iteration
        self.steps_per_call = max(int(steps_per_call), 1)
        # a device-resident training array (n, C, H, W); each step gathers
        # batch_size rows with indices drawn by its own device generator
        self.device_data = None
        if device_data is not None:
            self.device_data = torch.as_tensor(np.asarray(device_data, np.float32),
                                               device=self.device)
            self.index_generator = torch.Generator(self.device).manual_seed(seed + 2)

        self.params = list(self.model.parameters())
        # the module the training forward runs through: DDP averages the
        # gradients over the mesh (and broadcasts rank 0's weights at start)
        self.ddp = self.model
        if mesh is not None:
            self.ddp = torch.nn.parallel.DistributedDataParallel(self.model,
                                                                 process_group=mesh.group)
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)
        self.resume_step = 0
        self._load()
        self.step = self.resume_step
        self.sampler_state = self.sampler.init_state()

    def _local(self, x):
        """This rank's slice of a global batch (all of it without a mesh)."""
        return x if self.mesh is None else pmesh.shard_batch(x, self.mesh)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's slice, concatenated (``x`` itself without a mesh)."""
        return x if self.mesh is None else pmesh.all_gather_cat(x, self.mesh)

    # -- setup ----------------------------------------------------------------

    def _load(self) -> None:
        """Parameters, AdamW state and EMAs from the resume triplet; without
        one the EMAs start equal to the parameters."""
        path = self.resume_checkpoint
        names = [n for n, _ in self.model.named_parameters()]
        if path:
            self.resume_step = ckpt_io.parse_resume_step(path)
            self.model.load_state_dict(convert.load_unet_state_dict(path, self.model))
            print(f"loading model from checkpoint: {path} at step {self.resume_step}")
            self._load_optimizer(os.path.join(
                os.path.dirname(path),
                f"opt{self.resume_step:06d}{os.path.splitext(path)[1]}"), names)
        self.ema_params = []
        for rate in self.ema_rate:
            ema = [p.detach().clone() for p in self.params]
            ema_path = ckpt_io.find_ema_checkpoint(path or None, self.resume_step, str(rate))
            if ema_path:
                sd = convert.load_unet_state_dict(ema_path, self.model)
                ema = [sd[n].to(self.device, torch.float32) for n in names]
                print(f"loading EMA from checkpoint: {ema_path}")
            self.ema_params.append(ema)

    def _load_optimizer(self, opt_path: str, names: list[str]) -> None:
        if not os.path.exists(opt_path):
            return
        if opt_path.endswith(".pt"):
            self.opt.load_state_dict(convert.read_pt(opt_path))
            return
        saved = convert.adam_state_from_jax(convert.read_ckpt(opt_path), "unet", self.model)
        for name, p in zip(names, self.params):
            st = saved[name]
            self.opt.state[p] = {"step": st["step"].clone().float(),
                                 "exp_avg": st["exp_avg"].to(p.device, p.dtype),
                                 "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype)}

    def _update_count(self) -> int:
        """Updates applied so far (optax's schedule count)."""
        state = self.opt.state.get(self.params[0])
        return int(state["step"]) if state else 0

    def _lr(self) -> float:
        if not self.lr_anneal_steps:
            return self.lr
        frac = min(self._update_count(), self.lr_anneal_steps) / self.lr_anneal_steps
        return self.lr * (1.0 - frac)

    # -- steps ------------------------------------------------------------------

    def train_step(self, batch: torch.Tensor, t: torch.Tensor, weights: torch.Tensor,
                   noise: torch.Tensor) -> dict:
        """One optimizer step on the global ``batch`` with the given draws:
        ``t`` and ``weights`` ``(B,)`` on the host, ``noise`` like ``batch``
        (under a mesh each rank computes on its slice of all four).
        Returns the step's metrics as floats (NaN for an empty loss
        quartile), of the global batch."""
        t_all = t
        batch, t, weights, noise = self._local((batch, t, weights, noise))
        batch = torch.as_tensor(batch, device=self.device)
        n_micro = max(self.batch_size // self.microbatch, 1)
        if batch.shape[0] % n_micro:
            raise ValueError(f"{batch.shape[0]} rows a rank do not split into "
                             f"{n_micro} microbatches")
        micro = batch.shape[0] // n_micro
        self.opt.zero_grad(set_to_none=True)
        loss_total, terms_all = 0.0, []
        for i in range(n_micro):
            sl = slice(i * micro, (i + 1) * micro)
            # DDP averages the gradients once, after the last microbatch
            sync = self.ddp.no_sync() if self.mesh is not None and i < n_micro - 1 \
                else contextlib.nullcontext()
            with sync:
                terms = self.diffusion.training_losses(self.ddp, batch[sl], t[sl],
                                                       noise=noise[sl])
                loss = (terms["loss"] * weights[sl].to(self.device)).mean() / n_micro
                loss.backward()
            loss_total += loss.detach()
            terms_all.append({k: v.detach() for k, v in terms.items()})
        terms = {k: self._gather(torch.cat([tm[k] for tm in terms_all]))
                 for k in terms_all[0]}
        if self.mesh is not None:
            loss_total = self._gather(loss_total.reshape(1)).mean()

        grad_norm = global_norm(p.grad for p in self.params)
        grads_ok = bool(torch.isfinite(grad_norm))
        if grads_ok:
            for group in self.opt.param_groups:
                group["lr"] = self._lr()
            self.opt.step()
        for ema, rate in zip(self.ema_params, self.ema_rate):
            tnn.update_ema(ema, self.params, rate)
        # the global batch's t and losses: every rank's sampler state is the same
        losses = terms["loss"].cpu()
        self.sampler_state = self.sampler.update(self.sampler_state, t_all, losses)
        self.step += 1

        metrics = {"loss": float(loss_total), "grad_norm": float(grad_norm),
                   "param_norm": float(global_norm(p.detach() for p in self.params)),
                   "skipped_nonfinite": 0.0 if grads_ok else 1.0}
        quartile = (4 * t_all / self.diffusion.num_timesteps).long()
        for q in range(4):
            mask = quartile == q
            metrics[f"loss_q{q}"] = (float(losses[mask].mean()) if mask.any()
                                     else float("nan"))
        for k in ("mse", "vb"):
            if k in terms:
                metrics[k] = float(terms[k].mean())
        return metrics

    @torch.no_grad()
    def valid_step(self, batch: torch.Tensor, t: torch.Tensor, weights: torch.Tensor,
                   noise: torch.Tensor) -> float:
        """The weighted validation MSE of the current parameters on the
        global ``batch`` (under a mesh, the mean of the ranks' slices)."""
        batch, t, weights, noise = self._local((batch, t, weights, noise))
        terms = self.diffusion.training_losses(
            self.model, torch.as_tensor(batch, device=self.device), t, noise=noise,
            valid=True)
        mse = (terms["valid_mse"] * weights.to(self.device)).mean()
        return float(self._gather(mse.reshape(1)).mean())

    def _draws(self, batch):
        """The global batch's draws, alike on every rank."""
        t, weights, _ = self.sampler.sample(self.sampler_state, self.generator,
                                            batch.shape[0])
        noise = torch.randn(batch.shape, generator=self.noise_generator,
                            device=self.device, dtype=torch.float32)
        return t, weights, noise

    def device_batch(self) -> torch.Tensor:
        """``batch_size`` rows of ``device_data`` at indices drawn on the
        device (with replacement, as the JAX loop's ``randint``): the global
        batch, alike on every rank of a mesh."""
        idx = torch.randint(0, self.device_data.shape[0], (self.batch_size,),
                            generator=self.index_generator, device=self.device)
        return self.device_data[idx]

    def _step(self, batch) -> dict:
        """One training step on the global ``batch`` and, with
        ``valid_data``, the validation forward on its next batch; returns
        the step's metrics."""
        metrics = self.train_step(batch, *self._draws(batch))
        if self.valid_data is not None:
            vbatch = next(self.valid_data)[0]
            metrics["valid_mse"] = self.valid_step(vbatch, *self._draws(vbatch))
        return metrics

    def run_steps(self, k: int) -> None:
        """``k`` steps, logged once as the mean of each metric's finite
        values over them (``confild_tpu/train/diffusion_trainer.py:
        369-405``).  With ``device_data`` each step gathers its batch on
        the device; otherwise each takes the next batch of ``data`` (and
        of ``valid_data``, for its validation forward)."""
        all_metrics = [self._step(self.device_batch() if self.device_data is not None
                                  else next(self.data)[0]) for _ in range(k)]
        logger = tlog.get_current()
        logger.logkv("step", self.step)
        logger.logkv("samples", self.step * self.batch_size * pmesh.process_count())
        for name in all_metrics[0]:
            vals = np.asarray([m[name] for m in all_metrics], np.float64)
            finite = vals[np.isfinite(vals)]
            if finite.size:
                logger.logkv_mean(name, float(finite.mean()))

    def run_step(self, batch) -> None:
        metrics = self._step(batch)
        logger = tlog.get_current()
        logger.logkv("step", self.step)
        logger.logkv("samples", (self.step + 1) * self.batch_size * pmesh.process_count())
        for k, v in metrics.items():
            if not np.isnan(v):
                logger.logkv_mean(k, v)

    # -- loop -------------------------------------------------------------------

    def run_loop(self) -> None:
        """Step until ``lr_anneal_steps`` total steps (forever when 0; with
        ``steps_per_call`` k a call may pass it by up to k - 1 steps),
        logging every ``log_interval`` and saving every ``save_interval``
        steps and at the end (``confild_tpu/train/diffusion_trainer.py:
        346-367``)."""
        logger = tlog.get_current()
        k = self.steps_per_call
        while not self.lr_anneal_steps or self.step < self.lr_anneal_steps:
            if k > 1 or self.device_data is not None:
                self.run_steps(k)
            else:
                batch, _cond = next(self.data)
                self.run_step(batch)
            if self.step % self.log_interval < k:
                logger.dumpkvs()
            if self.step % self.save_interval < k and self.step >= self.save_interval:
                self.save()
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    return
        self.save()

    # -- checkpoints ------------------------------------------------------------

    def ema_state_dict(self, i: int = 0) -> dict:
        """The EMA of rate ``ema_rate[i]`` as a U-Net state dict."""
        names = [n for n, _ in self.model.named_parameters()]
        return dict(zip(names, self.ema_params[i]))

    def save(self) -> dict:
        """The triplet at the current step (rank 0 writes; every rank
        waits for it)."""
        paths = ckpt_io.diffusion_paths(self.save_dir, self.step, self.ema_rate)
        ckpt_io.save(paths["model"], _to_cpu(self.model.state_dict()))
        for i, rate in enumerate(self.ema_rate):
            ckpt_io.save(paths["ema"][rate], _to_cpu(self.ema_state_dict(i)))
        opt = self.opt.state_dict()
        opt["state"] = {k: _to_cpu(v) for k, v in opt["state"].items()}
        ckpt_io.save(paths["opt"], opt)
        if self.keep_checkpoints:
            ckpt_io.rotate_checkpoints(self.save_dir, self.keep_checkpoints, kind="diffusion")
        pmesh.barrier(self.mesh)
        if pmesh.process_index() == 0:
            print(f"saved checkpoint at step {self.step}")
        return paths


def load_latent_image_data(train_path: str, valid_path: str | None, batch_size: int,
                           seed: int = 42, scale_minmax: tuple | None = None):
    """Latent-image dataset pipeline (reference ``scripts/train.py:44-61``),
    the JAX package's numpy pipeline unchanged: load .npy, global min-max to
    [-1, 1], add the channel dim, an infinite shuffled iterator.  Returns
    ``(train_iter, valid_iter, (max, min))``."""
    train = np.load(train_path).astype(np.float32)
    mx, mn = (float(train.max()), float(train.min())) if scale_minmax is None else scale_minmax

    def prep(arr):
        return ((arr - mn) / (mx - mn) * 2 - 1)[:, None, ...]

    train = prep(train)
    valid = prep(np.load(valid_path).astype(np.float32)) if valid_path else None

    def infinite(arr, bs, seed):
        rng = np.random.default_rng(seed)
        while True:
            perm = rng.permutation(arr.shape[0])
            for i in range(0, len(perm) - bs + 1, bs):
                yield arr[perm[i:i + bs]], {}

    return (infinite(train, batch_size, seed),
            infinite(valid, batch_size, seed + 1) if valid is not None else None,
            (mx, mn))
