"""Noised-classifier training for classifier guidance, the port of
``confild_tpu/train/classifier_trainer.py`` (upstream guided-diffusion's
``classifier_train.py``; the reference ships the classifier,
``EncoderUNetModel``, and the guidance hooks, ``condition_mean`` /
``condition_score``, but no trainer).

A step diffuses the batch to a uniformly drawn ``t`` (``q_sample``), runs
the encoder, takes the softmax cross-entropy of its float32 logits and
steps AdamW with optax's defaults (``b1`` 0.9, ``b2`` 0.999, ``eps`` 1e-8,
decoupled weight decay on every parameter) at the linear anneal of
``lr`` to 0 over ``lr_anneal_steps`` (optax's ``linear_schedule``: the lr
of an update is ``lr * (1 - count / N)``, ``count`` the updates applied so
far).  Loss and accuracy go to the port's logger.  The draws (``t``, the
noise) are kept apart from the step: :meth:`ClassifierTrainLoop.train_step`
takes them as tensors, so a test can feed the port the JAX step's.

The loop trains ``model`` from its current weights (the CLI initialises
them from a seed).  Under a ``mesh`` every rank takes the global batch and
its draws and keeps its slice; the encoder trains under DDP, and the logged
metrics are the global batch's, as in ``TrainLoop``.  Rank 0 writes
``model{step:06d}.pt`` and ``opt{step:06d}.pt``.

:func:`classifier_cond_fn` turns the trained classifier into the ``cond_fn``
of ``GaussianDiffusion.p_sample_loop`` / ``ddim_sample_loop``: ``scale *
grad_x log p(y | x_t, t)``.
"""

from __future__ import annotations

import os
from typing import Iterator

import torch
import torch.nn.functional as F

from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.io import checkpoint as ckpt_io
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.utils import logger as tlog


class ClassifierTrainLoop:
    """Train an ``EncoderUNetModel`` to classify *noised* latent images.

    ``data`` yields ``(x, y)``: ``x`` ``(B, C, H, W)`` in [-1, 1], ``y``
    ``(B,)`` int labels.  With ``noised`` each batch is diffused to a
    uniformly drawn timestep first, so that the classifier holds along the
    whole reverse trajectory (what ``cond_fn`` needs)."""

    def __init__(self, *, model, diffusion, data: Iterator, batch_size: int,
                 lr: float = 3e-4, weight_decay: float = 0.05, lr_anneal_steps: int = 0,
                 noised: bool = True, log_interval: int = 10, save_interval: int = 10000,
                 save_dir: str | None = None, mesh=None, seed: int = 42,
                 keep_checkpoints: int = 0, device=None):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.diffusion = diffusion
        self.data = data
        self.batch_size = batch_size
        self.lr = lr
        self.lr_anneal_steps = lr_anneal_steps
        self.noised = noised
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.save_dir = save_dir or (tlog.get_current().dir or ".")
        self.keep_checkpoints = keep_checkpoints
        # t on the host, the noise on the device
        self.generator = torch.Generator().manual_seed(seed)
        self.noise_generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.params = list(self.model.parameters())
        self.ddp = self.model
        if mesh is not None:
            self.ddp = torch.nn.parallel.DistributedDataParallel(self.model,
                                                                 process_group=mesh.group)
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)
        self.step = 0

    def _local(self, x):
        return x if self.mesh is None else pmesh.shard_batch(x, self.mesh)

    def _lr(self) -> float:
        if not self.lr_anneal_steps:
            return self.lr
        return self.lr * (1.0 - min(self.step, self.lr_anneal_steps) / self.lr_anneal_steps)

    def train_step(self, x, y, t: torch.Tensor, noise: torch.Tensor) -> dict:
        """One AdamW step on the global batch ``(x, y)`` with the draws ``t``
        ``(B,)`` and ``noise`` (like ``x``); returns the global batch's mean
        ``loss`` and ``acc`` as floats."""
        x, y, t, noise = self._local((x, y, t, noise))
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, dtype=torch.long, device=self.device)
        t = t.to(self.device)
        if self.noised:
            x = self.diffusion.q_sample(x, t, noise.to(self.device))
        self.opt.zero_grad(set_to_none=True)
        logits = self.ddp(x, t).float()
        loss = F.cross_entropy(logits, y)
        loss.backward()
        for group in self.opt.param_groups:
            group["lr"] = self._lr()
        self.opt.step()
        self.step += 1
        metrics = torch.stack([loss.detach(), (logits.argmax(-1) == y).float().mean()])
        if self.mesh is not None:      # equal shards: the mean of the means
            pmesh.all_reduce_mean_([metrics], self.mesh)
        loss, acc = metrics.tolist()
        return {"loss": loss, "acc": acc}

    def _draws(self, x):
        t = torch.randint(0, self.diffusion.num_timesteps, (x.shape[0],),
                          generator=self.generator)
        noise = torch.randn(tuple(x.shape), generator=self.noise_generator,
                            device=self.device)
        return t, noise

    def run_step(self, x, y) -> dict:
        return self.train_step(x, y, *self._draws(x))

    def run_loop(self, steps: int | None = None) -> None:
        """Step to ``steps`` (default ``lr_anneal_steps``) total steps,
        logging every ``log_interval`` and saving every ``save_interval``
        steps and at the end (``confild_tpu/train/classifier_trainer.py:
        132-148``)."""
        logger = tlog.get_current()
        total = steps if steps is not None else self.lr_anneal_steps
        if not total:
            raise ValueError("pass steps= or set lr_anneal_steps")
        while self.step < total:
            x, y = next(self.data)
            metrics = self.run_step(x, y)
            logger.logkv("step", self.step)
            logger.logkv_mean("loss", metrics["loss"])
            logger.logkv_mean("acc", metrics["acc"])
            if self.step % self.log_interval == 0:
                logger.dumpkvs()
            if self.step % self.save_interval == 0 and self.step >= self.save_interval:
                self.save()
        self.save()

    def save(self) -> dict:
        """``model{step:06d}.pt`` (the encoder's state dict) and
        ``opt{step:06d}.pt`` (AdamW's), rank 0 writing; every rank waits."""
        paths = {"model": os.path.join(self.save_dir, f"model{self.step:06d}.pt"),
                 "opt": os.path.join(self.save_dir, f"opt{self.step:06d}.pt")}
        ckpt_io.save(paths["model"], {k: v.detach().cpu()
                                      for k, v in self.model.state_dict().items()})
        opt = self.opt.state_dict()
        opt["state"] = {k: {n: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                            for n, v in st.items()} for k, st in opt["state"].items()}
        ckpt_io.save(paths["opt"], opt)
        if self.keep_checkpoints:
            ckpt_io.rotate_checkpoints(self.save_dir, self.keep_checkpoints, kind="diffusion")
        pmesh.barrier(self.mesh)
        tlog.log(f"saved classifier checkpoint at step {self.step}")
        return paths


def classifier_cond_fn(model, scale: float = 1.0):
    """``cond_fn(x, t, y=...) -> scale * grad_x log p(y | x_t, t)`` for
    ``GaussianDiffusion.condition_mean`` / ``condition_score`` (upstream
    ``classifier_sample.py``; hooks at ``src/gaussian_diffusion.py:356-393``).
    The labels ``y`` come from the loop's ``model_kwargs``."""

    def cond_fn(x, t, y=None, **kwargs):
        if y is None:
            raise ValueError("classifier guidance needs labels y")
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            logp = F.log_softmax(model(x_in, t).float(), dim=-1)
            selected = logp.gather(-1, y.to(logp.device).long()[:, None]).sum()
            (grad,) = torch.autograd.grad(selected, x_in)
        return scale * grad

    return cond_fn
