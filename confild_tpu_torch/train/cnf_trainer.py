"""Auto-decoding CNF trainer, the port of ``confild_tpu/train/cnf_trainer.py``
(reference ``ConditionalNeuralField/scripts/train.py``).

Training dynamics reproduced exactly (they carry load):

* two Adam optimizers: the latent table ``(N_samples, F)`` (zero-init)
  steps **per batch** with a dense gradient, so every row's moments decay;
  the decoder steps **once per epoch** on the gradients summed over the
  epoch's batches, skipping global epoch 0 (reference ``:399-416``).  The
  last epoch's sum stays unapplied and unsaved.  ``nf_optim_cadence:
  batch`` steps the decoder with every batch instead;
* batch order from ``np.random.default_rng(0).permutation(n)`` per epoch,
  drawn in the same order as the JAX trainer;
* optional cosine tails (``lr.nf_end`` / ``lr.latents_end`` /
  ``lr.decay_epochs``) with optax semantics: step 0 takes the initial lr
  and the schedule counts optimizer steps;
* MSE on normalized fields; an rMAE eval on denormalized fields and a
  checkpoint at every ``save_every`` boundary and at the last epoch.

The decoder is any name of the registry (``NF.name``; the zoo of
``models/cnf_zoo.py``), called as ``model(coords, rows)`` wherever the JAX
trainer calls ``model(params, coords, rows)``.  On the card the
``SIRENAutodecoder_film`` decode is the fused train op (forward kernel;
backward the training kernel, ``csrc/siren_decode_bwd.cu``), as the JAX
trainer fuses that name only (``cnf_trainer.py:194-202``);
``use_fused_decode: false``, every other name and ``extra_siren_in`` (a
parametric CNF: a scalar per sample prepended as a coordinate channel,
``SIRENAutodecoder_film_extra_in``) take the plain autograd path, as the JAX
jnp path does.  Every decoder parameter (``SIRENAutodecoder_tw_film``'s
``w0`` too) steps with the decoder's Adam.  Plain Python loops take the place
of the JAX trainer's ``lax.scan``.

Data parallelism (``mesh``, the JAX trainer's ``shard_map`` over the batch,
``cnf_trainer.py:368-380``): every rank draws the same permutation and the
same latent noise, keeps its contiguous part of each batch's rows and runs
the decode (the kernels, on the card) on those rows only.  The gradients of
the latent table and of the decoder are averaged over the mesh with an
explicit all-reduce: the latent table's before each of its steps, the
decoder's before each of its steps under ``nf_optim_cadence: batch`` and
once at the end of each epoch under the reference cadence, where the
decoder steps once an epoch on the sum of its batches' gradients (an
all-reduce placed by the trainer fits both cadences, where DDP would
reduce every backward and need ``no_sync`` for the epoch's sum).  The
state stays the same on every rank; rank 0 writes the files.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from einops import rearrange

from confild_tpu_torch.core import normalize as cnorm
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.io import checkpoint as ckpt_io
from confild_tpu_torch.io import convert
from confild_tpu_torch.models import cnf as cnf_models
from confild_tpu_torch.ops.siren_decode import fused_siren_decode, fused_siren_decode_train
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.train.schedulers import cosine_decay_schedule
from confild_tpu_torch.utils import logger as tlog
from confild_tpu_torch.utils import readdata


def rMAE(prediction, target, dims):
    """Relative MAE per (sample, channel) (reference ``scripts/train.py:66``)."""
    dims = tuple(dims)
    return (prediction - target).abs().mean(dim=dims) / target.abs().mean(dim=dims)


TEST_CRITERIA = {"rMAE": rMAE}
LOSS_FNS = {"MSELoss": lambda pred, target: torch.mean((pred - target) ** 2)}

# root of the per-(epoch, batch) latent-noise seeds
NOISE_SEED = 0xC0F1


@dataclasses.dataclass
class CNFTrainState:
    """The trainer's live state: the decoder's parameters (and, between
    epochs, its summed gradients in ``.grad``), the latent table and both
    optimizers."""
    model: torch.nn.Module
    latents: torch.nn.Parameter        # (N_samples, F)
    opt_nf: torch.optim.Adam
    opt_lat: torch.optim.Adam
    epoch: int


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _noise_generator(device: torch.device, epoch: int, batch: int) -> torch.Generator:
    seed = np.random.SeedSequence([NOISE_SEED, epoch, batch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed) >> 1)


def _adam_step(opt: torch.optim.Adam, schedule) -> None:
    """One Adam step at ``schedule(count)``, ``count`` the steps taken so
    far (optax's ``scale_by_schedule`` count)."""
    state = opt.state.get(opt.param_groups[0]["params"][0])
    count = int(state["step"]) if state else 0
    for group in opt.param_groups:
        group["lr"] = schedule(count)
    opt.step()


class CNFTrainer:
    """Recipe-driven auto-decoding trainer: ``train()``, ``load(ckpt_id,
    siren_only)``, ``infer(coords, latents)`` and ``eval_rmae()``.

    Runs on ``device`` (default: the recipe's ``device`` key, else the
    CUDA card; without a card it raises unless asked for the CPU), data
    parallel over ``mesh`` when one is given."""

    def __init__(self, hp, infer_mode: bool = False, device=None, mesh=None):
        self.hp = hp
        self.mesh = mesh
        self.device = resolve_device(device if device is not None else hp.get("device"))
        self.save_path = hp.save_path
        # extra scalar SIREN input (parametric CNF, reference :117-136): an
        # int n is linspace(0, 1, n), a triple the linspace arguments, else
        # the explicit values
        self.extra_siren_in = None
        spec = hp.get("extra_siren_in")
        if spec is not None:
            if isinstance(spec, int):
                self.extra_siren_in = np.linspace(0, 1, spec, dtype=np.float32)
            elif len(spec) == 3:
                self.extra_siren_in = np.linspace(*spec, dtype=np.float32)
            else:
                self.extra_siren_in = np.asarray(spec, np.float32)

        if not infer_mode:
            fois = self._load_fois(hp)
            fois = rearrange(fois, f"{hp.readin_data_shape} -> {hp.batch_shape}")
            nf_spec = hp.NF
            out_features = (nf_spec.get("kwargs", {}).get("out_features")
                            or nf_spec["out_features"])
            assert out_features == fois.shape[-1], \
                "NF out_features inconsistent with data shape"
            if self.extra_siren_in is not None:
                # data layout (t, n_extra, *spatial, c): the first two axes
                # flatten into the sample axis (reference basic_set :34-38)
                self.n_extra = fois.shape[1]
                if self.n_extra != len(self.extra_siren_in):
                    raise ValueError(
                        f"extra_siren_in has {len(self.extra_siren_in)} values but the data "
                        f"has {self.n_extra} along its second axis")
                self.spatio_shape = fois.shape[2:-1]
                self.spatio_axis = list(range(1, fois.ndim - 2))
                fois = fois.reshape(fois.shape[0] * self.n_extra, *fois.shape[2:])
            else:
                self.spatio_shape = fois.shape[1:-1]
                self.spatio_axis = list(range(1, fois.ndim - 1))
            coords = self._load_coords(hp)
            self.train_coord = np.asarray(coords, np.float32)
            self.N_samples = fois.shape[0]
            fois = np.asarray(fois, np.float32)

        # normalizers: fitted on the host in numpy, or loaded (reference
        # :169-217); the JAX package's .ckpt file is read first, as there
        self.in_normalizer = cnorm.Normalizer(**hp.normalizer)
        self.out_normalizer = cnorm.Normalizer(**hp.normalizer)
        # the extra scalar's own normalizer, saved as extra_normalizer_params
        self.extra_in_normalizer = (cnorm.Normalizer(**hp.normalizer)
                                    if self.extra_siren_in is not None else None)
        found = [p for p in (os.path.join(hp.save_path, name) for name in
                             ("normalizer_params.ckpt", "normalizer_params.pt"))
                 if os.path.exists(p)]
        # every rank has looked before rank 0 writes a fitted one
        pmesh.barrier(mesh)
        if found:
            params = convert.load_normalizer_file(found[0])
            self.in_normalizer.params = tuple(params["x_normalizer_params"])
            self.out_normalizer.params = tuple(params["y_normalizer_params"])
            if self.extra_in_normalizer is not None and "extra_normalizer_params" in params:
                self.extra_in_normalizer.params = tuple(params["extra_normalizer_params"])
        else:
            if infer_mode:
                raise FileNotFoundError(f"no normalizer params in {hp.save_path}")
            coord_fit = coords if hp.lumped_latent else coords.reshape(-1, coords.shape[-1])
            fois_fit = (fois if hp.lumped_latent
                        else fois.reshape(-1, *fois.shape[hp.dims + 1:]))
            self.in_normalizer.fit_normalize(coord_fit)
            self.out_normalizer.fit_normalize(fois_fit)
            fitted = {"x_normalizer_params": self.in_normalizer,
                      "y_normalizer_params": self.out_normalizer}
            if self.extra_in_normalizer is not None:
                self.extra_in_normalizer.fit_normalize(self.extra_siren_in.reshape(-1))
                fitted["extra_normalizer_params"] = self.extra_in_normalizer
            ckpt_io.save(os.path.join(hp.save_path, "normalizer_params.pt"), {
                key: tuple(torch.as_tensor(np.asarray(p)) for p in norm.get_params())
                for key, norm in fitted.items()})

        # built on the device: a hypernetwork decoder's constructor draws
        # its 0.85 G parameters there (init_state draws the seeded init)
        with torch.device(self.device):
            if self.extra_siren_in is not None:
                # the extra scalar is one more coordinate channel (reference
                # :229-240)
                nf_spec = hp.NF
                self.model = cnf_models.create_nf(
                    nf_spec["name"], in_coord_features=hp.dims + 1,
                    in_latent_features=hp.hidden_size, out_features=nf_spec["out_features"],
                    num_hidden_layers=nf_spec["num_hidden_layers"],
                    hidden_features=nf_spec["hidden_features"])
            else:
                self.model = cnf_models.siren_film_from_recipe(hp)
        self.nf_name = hp.NF["name"] if isinstance(hp.NF, dict) else hp.NF.get("name")
        # the kernels take the plain FiLM decoder; every other decoder and
        # the extra-input variant train on the plain path, as in the JAX
        # trainer
        self.use_fused_decode = (bool(hp.get("use_fused_decode", True))
                                 and self.nf_name == "SIRENAutodecoder_film"
                                 and self.extra_siren_in is None)
        # the FiLM decoder's frequency, which the fused route takes (None for
        # the zoo's decoders: tw_film's w0 is a parameter)
        self.w0 = self.model.w0 if isinstance(self.model, cnf_models.SirenFilm) else None

        if not infer_mode:
            dev = self.device
            self.normed_coords = torch.as_tensor(
                np.asarray(self.in_normalizer.normalize(self.train_coord), np.float32), device=dev)
            self.normed_fois = torch.as_tensor(
                np.asarray(self.out_normalizer.normalize(fois), np.float32), device=dev)
            # the fused decode takes flat (M, dims) coords and (n, M, c)
            # targets (the loss over flat points equals the loss over the grid)
            self.flat_coords = self.normed_coords.reshape(-1, self.normed_coords.shape[-1])
            self.flat_fois = self.normed_fois.reshape(self.N_samples, -1, self.normed_fois.shape[-1])
            if self.extra_in_normalizer is not None:
                self.normed_extra = torch.as_tensor(np.asarray(
                    self.extra_in_normalizer.normalize(self.extra_siren_in), np.float32),
                    device=dev)
        self.state: CNFTrainState | None = None
        self._schedules_cache = None

    # -- data ---------------------------------------------------------------

    @staticmethod
    def _load_fois(hp):
        if "load_data_fn" in hp:
            spec = hp.load_data_fn
            if isinstance(spec, str):
                return readdata.get_loader(spec)(hp.data_path)
            return readdata.get_loader(spec["name"])(hp.data_path, **spec.get("kwargs", {}))
        return np.load(hp.data_path)

    def _load_coords(self, hp):
        if "coor_path" in hp and hp.coor_path:
            coord = np.load(hp.coor_path)
            assert coord.shape[:-1] == self.spatio_shape
            assert coord.shape[-1] == hp.dims
            return coord
        axes = [np.linspace(0, 1, s, dtype=np.float32) for s in self.spatio_shape]
        return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)

    def expand_latents(self, rows: torch.Tensor) -> torch.Tensor:
        """(B, F) -> (B, 1...1, F) with ``dims`` ones (one when lumped), to
        broadcast against the coordinates (reference :43-63)."""
        n_ones = 1 if self.hp.lumped_latent else self.hp.dims
        return rows.reshape(rows.shape[0], *(1,) * n_ones, rows.shape[-1])

    # -- state --------------------------------------------------------------

    @property
    def _per_batch_nf(self) -> bool:
        """Opt-in decoder cadence ``nf_optim_cadence: batch``; the default
        is the reference's once-per-epoch step."""
        return str(self.hp.get("nf_optim_cadence", "epoch")) == "batch"

    def _schedules(self):
        """(nf, latents) lr schedules: constant, or the optional cosine
        tails; decay counts optimizer steps (per epoch for the decoder under
        the reference cadence, per batch for the latents)."""
        lr = self.hp.lr
        n_batches = max(self.N_samples // self.hp.batch_size, 1)
        decay_epochs = lr.get("decay_epochs", self.hp.epochs)

        def sched(init, end, steps):
            if end is None:
                return lambda count: init
            return cosine_decay_schedule(init, max(steps, 1), alpha=end / init)

        nf_steps = decay_epochs * (n_batches if self._per_batch_nf else 1)
        return (sched(lr["nf"], lr.get("nf_end"), nf_steps),
                sched(lr["latents"], lr.get("latents_end"), decay_epochs * n_batches))

    def _fresh_latents(self) -> torch.Tensor:
        """Zeros (reference parity), or the table in ``latent_init``."""
        path = self.hp.get("latent_init")
        if not path:
            return torch.zeros((self.N_samples, self.hp.hidden_size), device=self.device)
        init = np.load(path)
        if init.shape != (self.N_samples, self.hp.hidden_size):
            raise ValueError(f"latent_init {path}: shape {init.shape} != "
                             f"({self.N_samples}, {self.hp.hidden_size})")
        return torch.as_tensor(init, dtype=torch.float32, device=self.device)

    def _new_state(self, latents: torch.Tensor, epoch: int) -> CNFTrainState:
        lat = torch.nn.Parameter(latents.to(self.device, torch.float32))
        if self.mesh is not None:
            pmesh.replicate([*self.model.parameters(), lat], self.mesh)
        opt_nf = torch.optim.Adam(self.model.parameters(), lr=self.hp.lr["nf"])
        opt_lat = torch.optim.Adam([lat], lr=self.hp.lr["latents"])
        self.model.zero_grad(set_to_none=True)
        self.state = CNFTrainState(self.model, lat, opt_nf, opt_lat, int(epoch))
        return self.state

    def init_state(self, model_state: dict | None = None, seed: int = 0) -> CNFTrainState:
        """Fresh state: the decoder from ``model_state`` or a SIREN init
        seeded by ``seed``, fresh latents, fresh optimizers, epoch 0."""
        if model_state is not None:
            self.model.load_state_dict(model_state)
        else:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        return self._new_state(self._fresh_latents(), 0)

    # -- train --------------------------------------------------------------

    def _local(self, x):
        """This rank's part of a batch (all of it without a mesh)."""
        return x if self.mesh is None else pmesh.shard_batch(x, self.mesh)

    def _batch_loss(self, idx: torch.Tensor, epoch: int, batch: int) -> torch.Tensor:
        """The loss of this rank's rows of the batch ``idx`` (every row
        without a mesh)."""
        hp = self.hp
        n_rows = idx.shape[0]
        idx = self._local(idx)
        rows_clean = self.state.latents[idx]
        rows = rows_clean
        # latent-noise regularization (beyond reference, opt-in; 0 = parity):
        # the generator is seeded per epoch and batch, so a resume repeats
        # it; the whole batch's noise is drawn, and this rank's rows kept
        noise_std = float(hp.get("latent_noise_std", 0.0) or 0.0)
        if noise_std:
            rows = rows + noise_std * self._local(torch.randn(
                (n_rows, rows.shape[-1]),
                generator=_noise_generator(self.device, epoch, batch), device=self.device))
        if self.extra_siren_in is not None:
            out = self._extra_in_decode(idx, rows)
            target = self.normed_fois[idx]
        elif self.use_fused_decode:
            out = fused_siren_decode_train(self.model, self.flat_coords, rows, self.w0)
            target = self.flat_fois[idx]
        else:
            out = self.model(self.normed_coords, self.expand_latents(rows))
            target = self.normed_fois[idx]
        loss = LOSS_FNS[hp.loss_fn](out, target)
        latent_l2 = float(hp.get("latent_l2", 0.0) or 0.0)   # opt-in code prior
        if latent_l2:
            loss = loss + latent_l2 * torch.mean(rows_clean ** 2)
        return loss

    def _extra_in_decode(self, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """The extra-input decode of samples ``idx``: sample ``i`` is
        trajectory ``i // n_extra`` at extra value ``i % n_extra``
        (reference basic_set :34-38)."""
        ex = self.normed_extra[idx % self.n_extra].reshape(
            (idx.shape[0],) + (1,) * (len(self.spatio_shape) + 1))
        return self.model((self.normed_coords, ex), self.expand_latents(rows))

    def _apply_nf_step(self) -> None:
        """The once-per-epoch decoder step on the summed gradients; a
        parameter with no gradient yet steps on zeros, as the JAX trainer's
        zero accumulator does after a resume."""
        self._decoder_grads()
        _adam_step(self.state.opt_nf, self._schedules_cache[0])
        self.model.zero_grad(set_to_none=False)

    def _decoder_grads(self) -> list[torch.Tensor]:
        """The decoder's ``.grad`` tensors; a parameter with no gradient
        yet gets zeros, as the JAX trainer's zero accumulator after a
        resume."""
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.model.parameters()]

    def _mean_over_mesh(self, tensors) -> None:
        if self.mesh is not None:
            pmesh.all_reduce_mean_(tensors, self.mesh)

    def _run_epoch(self, perm: np.ndarray, epoch: int, fix_nf: bool) -> float:
        per_batch_nf = not fix_nf and self._per_batch_nf
        nf_sched, lat_sched = self._schedules_cache
        if not fix_nf and not per_batch_nf and epoch != 0:
            self._apply_nf_step()
        s = self.state
        losses = []
        for b, idx in enumerate(perm):
            idx = torch.as_tensor(idx, device=self.device)
            s.latents.grad = None
            if per_batch_nf:
                self.model.zero_grad(set_to_none=True)
            loss = self._batch_loss(idx, epoch, b)
            loss.backward()     # decoder grads add up in .grad over the epoch
            self._mean_over_mesh([s.latents.grad])
            _adam_step(s.opt_lat, lat_sched)
            if per_batch_nf:
                self._mean_over_mesh(self._decoder_grads())
                _adam_step(s.opt_nf, nf_sched)
            losses.append(loss.detach())
        if self.mesh is not None and not fix_nf and not per_batch_nf:
            # the epoch's summed decoder gradient, the same on every rank
            self._mean_over_mesh(self._decoder_grads())
        losses = torch.stack(losses)
        self._mean_over_mesh([losses])
        return float(losses.mean())

    def train(self, fix_nf: bool = False, log_formats=("stdout",)) -> CNFTrainState:
        hp = self.hp
        if self.state is None:
            self.init_state()
        if self._schedules_cache is None:
            self._schedules_cache = self._schedules()
        logger = tlog.configure(hp.save_path, list(log_formats) + ["csv"])
        n = self.N_samples
        n_batches = max(n // hp.batch_size, 1)
        rng = np.random.default_rng(0)
        start = self.state.epoch
        end = start + hp.epochs
        if hp.epochs <= 0:   # no-op continuation: don't rewind the epoch
            return self.state
        # the JAX trainer's ``epochs_per_chunk`` groups epochs into one
        # compiled program; eager PyTorch has nothing to amortize, so the
        # key is accepted and ignored (the permutations are drawn in the
        # same order either way)
        eval_epochs = sorted({e for e in range(start, end) if e % hp.save_every == 0}
                             | {end - 1})
        cursor = start
        for target in eval_epochs:
            while cursor <= target:
                perm = rng.permutation(n)[: n_batches * hp.batch_size].reshape(
                    n_batches, hp.batch_size)
                with logger.profile_kv("train_chunk"):
                    loss = self._run_epoch(perm, cursor, fix_nf)
                logger.logkv("epoch", cursor)
                logger.logkv("loss", loss)
                logger.dumpkvs()
                cursor += 1
            self.state.epoch = target
            with logger.profile_kv("eval"):
                test_error = self.eval_rmae()
            logger.logkv("epoch", target)
            for k, v in enumerate(test_error):
                logger.logkv(f"test_error_{k}", float(v))
            logger.dumpkvs()
            with logger.profile_kv("save"):
                self.save(target)
        self.state.epoch = end - 1
        return self.state

    @torch.no_grad()
    def eval_rmae(self) -> np.ndarray:
        """rMAE per channel over every snapshot, in ``test_batch_size``
        chunks of denormalized fields (reference :429-459).  The last chunk
        is simply shorter: eager PyTorch needs no padded fixed shape, and
        every snapshot counts once as in the JAX trainer's masked mean.
        Under a mesh each rank evaluates its contiguous part of the
        snapshots, and the sums are all-reduced."""
        n = self.N_samples
        eval_bs = min(self.hp.test_batch_size, n)
        denorm = self.out_normalizer.to(self.device).denormalize
        criteria = TEST_CRITERIA[self.hp.test_criteria]
        snapshots = torch.arange(n, device=self.device)
        if self.mesh is not None:
            index, shards = self.mesh.batch_index()
            snapshots = snapshots.tensor_split(shards)[index]
        total = torch.zeros(self.flat_fois.shape[-1], device=self.device)
        for idx in snapshots.split(eval_bs):
            rows = self.state.latents[idx]
            if self.extra_siren_in is not None:
                pred = self._extra_in_decode(idx, rows)
                err = criteria(denorm(pred), denorm(self.normed_fois[idx]), self.spatio_axis)
            elif self.use_fused_decode:
                pred = fused_siren_decode(self.model, self.flat_coords, rows, self.w0)
                err = criteria(denorm(pred), denorm(self.flat_fois[idx]), (1,))
            else:
                pred = self.model(self.normed_coords, self.expand_latents(rows))
                err = criteria(denorm(pred), denorm(self.normed_fois[idx]), self.spatio_axis)
            total = total + err.sum(dim=0)
        if self.mesh is not None:
            dist.all_reduce(total, group=self.mesh.group)
        return (total / n).cpu().numpy()

    # -- checkpointing (4-part dict, reference :468-528) ---------------------

    def save(self, epoch: int) -> str:
        s = self.state
        path = os.path.join(self.save_path, f"checkpoint_{epoch}.pt")
        ckpt_io.save(path, {
            "epoch": int(epoch),
            "model_state_dict": _to_cpu(self.model.state_dict()),
            "hidden_states": {"latents": _to_cpu(s.latents)},
            "optim_net_dec_dict": _to_cpu(s.opt_nf.state_dict()),
            "optim_states_dict": _to_cpu(s.opt_lat.state_dict()),
        })
        # ``keep_checkpoints: N`` keeps the newest N generations (0 or
        # absent: every save, as the reference)
        keep = int(self.hp.get("keep_checkpoints", 0) or 0)
        if keep:
            ckpt_io.rotate_checkpoints(self.save_path, keep)
        pmesh.barrier(self.mesh)
        return path

    def _checkpoint_path(self, checkpoint_id: int) -> str | None:
        if checkpoint_id == -1:
            found = ckpt_io.latest_checkpoint(self.save_path, "checkpoint_*.ckpt")
            found_pt = ckpt_io.latest_checkpoint(self.save_path, "checkpoint_*.pt")
            if found is None and found_pt is None:
                return None
            if found is None or (found_pt is not None and found_pt[1] > found[1]):
                return found_pt[0]
            return found[0]
        path = os.path.join(self.save_path, f"checkpoint_{checkpoint_id}.ckpt")
        return path if os.path.exists(path) else path[: -len(".ckpt")] + ".pt"

    def load(self, checkpoint_id: int = -1, siren_only: bool = False):
        """Resume from ``checkpoint_{id}`` (-1: the newest ``.pt`` or JAX
        ``.ckpt``; none: start from scratch and return None).  Carries the
        decoder, the latents and both optimizers' states; ``siren_only``
        takes the decoder and its optimizer only, with fresh latents sized
        by the current dataset (reference :481-528)."""
        path = self._checkpoint_path(checkpoint_id)
        if path is None:
            print(f"*No checkpoint found in {self.save_path}*, starting from scratch")
            return None
        if path.endswith(".pt"):
            return self._load_pt(path, siren_only)
        ck = convert.read_ckpt(path)
        opt_nf, opt_lat = ck.get("optim_net_dec_dict"), ck.get("optim_states_dict")
        return self._restore(
            ck, convert.nf_state_dict_from_jax(self.nf_name, ck["model_state_dict"]),
            convert.adam_state_from_jax(opt_nf, "decoder") if opt_nf else None,
            convert.adam_state_from_jax(opt_lat, "latents") if opt_lat else None, siren_only)

    def _load_pt(self, path: str, siren_only: bool):
        """A ``.pt`` checkpoint: the port's own or the reference's (torch
        optimizer state dicts, possibly empty)."""
        ck = convert.read_pt(path)
        model_state = {k.removeprefix("module."): v for k, v in ck["model_state_dict"].items()}
        return self._restore(ck, model_state, ck.get("optim_net_dec_dict"),
                             ck.get("optim_states_dict"), siren_only)

    def _restore(self, ck: dict, model_state: dict, opt_nf, opt_lat, siren_only: bool):
        self.model.load_state_dict(model_state)
        hs = ck.get("hidden_states")
        latents_ck = None if hs is None else convert.latents_from_hidden_states(hs)
        if not hasattr(self, "N_samples") and latents_ck is not None:
            self.N_samples = latents_ck.shape[0]     # infer mode: no dataset
        if siren_only or latents_ck is None:
            latents, opt_lat = self._fresh_latents(), None
        else:
            latents = torch.tensor(latents_ck, dtype=torch.float32)
            self.N_samples = latents.shape[0]
        s = self._new_state(latents, int(np.asarray(ck.get("epoch") or 0)))
        self._load_optimizer(s.opt_nf, dict(self.model.named_parameters()), opt_nf)
        self._load_optimizer(s.opt_lat, {"latents": s.latents}, opt_lat)
        return s

    @staticmethod
    def _load_optimizer(opt: torch.optim.Adam, params: dict, saved) -> None:
        """A torch ``state_dict`` as saved by the port or the reference, or
        the per-parameter states of :func:`convert.adam_state_from_jax`."""
        if not saved:
            return
        if "param_groups" in saved:
            opt.load_state_dict(saved)
            return
        for name, p in params.items():
            st = saved[name]
            opt.state[p] = {"step": st["step"].clone().float(),
                            "exp_avg": st["exp_avg"].to(p.device, p.dtype),
                            "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype)}

    # -- inference (reference :265-279) --------------------------------------

    @torch.no_grad()
    def infer(self, coord, latents, batch: int | None = None) -> torch.Tensor:
        """Decode latent rows at physical coordinates of any grid rank,
        denormalized, in chunks of ``batch`` rows (default
        ``test_batch_size``) so that bulk decodes fit in device memory."""
        coord = coord if coord is not None else self.train_coord
        coord = self.in_normalizer.to(self.device).normalize(
            torch.as_tensor(np.asarray(coord, np.float32), device=self.device))
        latents = torch.as_tensor(latents, dtype=torch.float32, device=self.device)
        denorm = self.out_normalizer.to(self.device).denormalize
        n_rows = latents.shape[0]
        chunk = batch or int(self.hp.get("test_batch_size", 0) or 64)
        chunk = max(1, min(chunk, n_rows))
        # one singleton per coordinate grid axis, for coords of any rank
        n_ones = max(coord.ndim - 1, 1)
        return torch.cat([
            denorm(self.model(
                coord, latents[lo:lo + chunk].reshape(-1, *(1,) * n_ones, latents.shape[-1])))
            for lo in range(0, n_rows, chunk)])
