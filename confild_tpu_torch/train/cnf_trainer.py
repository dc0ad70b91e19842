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

On the card the decode is the fused train op (forward kernel; backward the
training kernel, ``csrc/siren_decode_bwd.cu``); ``use_fused_decode: false``
takes the plain ``siren_film_apply`` autograd path, as the JAX jnp path
does.  Plain Python loops take the place of the JAX trainer's ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from einops import rearrange

from confild_tpu_torch.core import normalize as cnorm
from confild_tpu_torch.device import resolve_device
from confild_tpu_torch.io import checkpoint as ckpt_io
from confild_tpu_torch.io import convert
from confild_tpu_torch.models import cnf as cnf_models
from confild_tpu_torch.models.cnf import siren_film_apply
from confild_tpu_torch.ops.siren_decode import fused_siren_decode, fused_siren_decode_train
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
    CUDA card; without a card it raises unless asked for the CPU)."""

    def __init__(self, hp, infer_mode: bool = False, device=None):
        self.hp = hp
        self.device = resolve_device(device if device is not None else hp.get("device"))
        self.save_path = hp.save_path
        if hp.get("extra_siren_in") is not None:
            raise NotImplementedError(
                "extra_siren_in (the SIRENAutodecoder_film_extra_in NF) is not ported "
                "yet (ROADMAP.md Queue 1, item 11: rest of the model zoo)")
        if int(hp.get("multiGPU", 1) or 1) > 1:
            print(f"multiGPU: {hp.multiGPU} requested; the port trains on one card "
                  "(the multi-device slice, ROADMAP.md Queue 1, item 13, is still to come)")

        if not infer_mode:
            fois = self._load_fois(hp)
            fois = rearrange(fois, f"{hp.readin_data_shape} -> {hp.batch_shape}")
            nf_spec = hp.NF
            out_features = (nf_spec.get("kwargs", {}).get("out_features")
                            or nf_spec["out_features"])
            assert out_features == fois.shape[-1], \
                "NF out_features inconsistent with data shape"
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
        for name in ("normalizer_params.ckpt", "normalizer_params.pt"):
            path = os.path.join(hp.save_path, name)
            if os.path.exists(path):
                params = convert.load_normalizer_file(path)
                self.in_normalizer.params = tuple(params["x_normalizer_params"])
                self.out_normalizer.params = tuple(params["y_normalizer_params"])
                break
        else:
            if infer_mode:
                raise FileNotFoundError(f"no normalizer params in {hp.save_path}")
            coord_fit = coords if hp.lumped_latent else coords.reshape(-1, coords.shape[-1])
            fois_fit = (fois if hp.lumped_latent
                        else fois.reshape(-1, *fois.shape[hp.dims + 1:]))
            self.in_normalizer.fit_normalize(coord_fit)
            self.out_normalizer.fit_normalize(fois_fit)
            ckpt_io.save(os.path.join(hp.save_path, "normalizer_params.pt"), {
                "x_normalizer_params": tuple(torch.as_tensor(np.asarray(p))
                                             for p in self.in_normalizer.get_params()),
                "y_normalizer_params": tuple(torch.as_tensor(np.asarray(p))
                                             for p in self.out_normalizer.get_params()),
            })

        self.model = cnf_models.siren_film_from_recipe(hp).to(self.device)
        self.w0 = self.model.w0
        nf_name = hp.NF["name"] if isinstance(hp.NF, dict) else hp.NF.get("name")
        self.use_fused_decode = (bool(hp.get("use_fused_decode", True))
                                 and nf_name == "SIRENAutodecoder_film")

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

    def _batch_loss(self, idx: torch.Tensor, epoch: int, batch: int) -> torch.Tensor:
        hp = self.hp
        rows_clean = self.state.latents[idx]
        rows = rows_clean
        # latent-noise regularization (beyond reference, opt-in; 0 = parity):
        # the generator is seeded per epoch and batch, so a resume repeats it
        noise_std = float(hp.get("latent_noise_std", 0.0) or 0.0)
        if noise_std:
            rows = rows + noise_std * torch.randn(
                rows.shape, generator=_noise_generator(self.device, epoch, batch),
                device=self.device)
        if self.use_fused_decode:
            out = fused_siren_decode_train(self.model, self.flat_coords, rows, self.w0)
            target = self.flat_fois[idx]
        else:
            out = siren_film_apply(self.model, self.normed_coords, self.expand_latents(rows),
                                   self.w0)
            target = self.normed_fois[idx]
        loss = LOSS_FNS[hp.loss_fn](out, target)
        latent_l2 = float(hp.get("latent_l2", 0.0) or 0.0)   # opt-in code prior
        if latent_l2:
            loss = loss + latent_l2 * torch.mean(rows_clean ** 2)
        return loss

    def _apply_nf_step(self) -> None:
        """The once-per-epoch decoder step on the summed gradients; a
        parameter with no gradient yet steps on zeros, as the JAX trainer's
        zero accumulator does after a resume."""
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _adam_step(self.state.opt_nf, self._schedules_cache[0])
        self.model.zero_grad(set_to_none=False)

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
            _adam_step(s.opt_lat, lat_sched)
            if per_batch_nf:
                _adam_step(s.opt_nf, nf_sched)
            losses.append(loss.detach())
        return float(torch.stack(losses).mean())

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
        every snapshot counts once as in the JAX trainer's masked mean."""
        n = self.N_samples
        eval_bs = min(self.hp.test_batch_size, n)
        denorm = self.out_normalizer.to(self.device).denormalize
        criteria = TEST_CRITERIA[self.hp.test_criteria]
        total = 0.0
        for lo in range(0, n, eval_bs):
            idx = torch.arange(lo, min(lo + eval_bs, n), device=self.device)
            rows = self.state.latents[idx]
            if self.use_fused_decode:
                pred = fused_siren_decode(self.model, self.flat_coords, rows, self.w0)
                err = criteria(denorm(pred), denorm(self.flat_fois[idx]), (1,))
            else:
                pred = siren_film_apply(self.model, self.normed_coords,
                                        self.expand_latents(rows), self.w0)
                err = criteria(denorm(pred), denorm(self.normed_fois[idx]), self.spatio_axis)
            total = total + err.sum(dim=0)
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
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is an Orbax (multi-process) checkpoint of the JAX package; "
                "the port reads single-file checkpoints only (ROADMAP.md Queue 1, item 13)")
        if path.endswith(".pt"):
            return self._load_pt(path, siren_only)
        ck = convert.read_ckpt(path)
        opt_nf, opt_lat = ck.get("optim_net_dec_dict"), ck.get("optim_states_dict")
        return self._restore(
            ck, convert.cnf_state_dict_from_jax(ck["model_state_dict"]),
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
            denorm(siren_film_apply(
                self.model, coord,
                latents[lo:lo + chunk].reshape(-1, *(1,) * n_ones, latents.shape[-1]),
                self.w0))
            for lo in range(0, n_rows, chunk)])
