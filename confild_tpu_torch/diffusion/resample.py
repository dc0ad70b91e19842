"""Timestep schedule samplers (reference ``src/resample.py``;
``confild_tpu/diffusion/resample.py``).

The sampler state is explicit, as in the JAX package: ``init_state()``,
``sample(state, generator, batch_size) -> (t, weights, state)`` and
``update(state, t, losses) -> state``.  A ``torch.Generator`` takes the place
of the JAX key.  ``t`` is drawn on the host (int64): the diffusion gathers
its float64 schedule tables there.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class UniformSampler:
    num_timesteps: int

    def init_state(self):
        return ()

    def sample(self, state, generator: torch.Generator | None, batch_size: int):
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator)
        return t, torch.ones(batch_size), state

    def update(self, state, t, losses):
        return state


@dataclasses.dataclass(frozen=True)
class LossSecondMomentResampler:
    """Importance-sample t with p ∝ sqrt(E[loss^2]) once every t has
    ``history_per_term`` recorded losses, mixing in ``uniform_prob`` uniform
    mass (reference ``resample.py:124-154``)."""

    num_timesteps: int
    history_per_term: int = 10
    uniform_prob: float = 0.001

    def init_state(self):
        return {"history": torch.zeros((self.num_timesteps, self.history_per_term)),
                "counts": torch.zeros(self.num_timesteps, dtype=torch.int64)}

    def weights(self, state) -> torch.Tensor:
        """The sampling distribution over t (uniform until warmed up)."""
        if not bool((state["counts"] == self.history_per_term).all()):
            return torch.full((self.num_timesteps,), 1.0 / self.num_timesteps)
        w = torch.sqrt(torch.mean(state["history"] ** 2, dim=-1))
        w = w / torch.clamp(w.sum(), min=1e-20)
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def sample(self, state, generator: torch.Generator | None, batch_size: int):
        p = self.weights(state)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t]), state

    def update(self, state, t, losses):
        """Record per-sample losses into the history of their t, first in
        first out once full (reference ``:139-144``)."""
        history, counts = state["history"].clone(), state["counts"].clone()
        for ti, loss in zip(t.tolist(), losses.detach().float().cpu().tolist()):
            if counts[ti] == self.history_per_term:
                history[ti] = torch.roll(history[ti], -1)
                history[ti, -1] = loss
            else:
                history[ti, counts[ti]] = loss
                counts[ti] += 1
        return {"history": history, "counts": counts}


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
