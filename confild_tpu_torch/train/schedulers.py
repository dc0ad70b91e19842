"""Learning-rate schedules as plain functions of the optimizer step
(``confild_tpu/train/schedulers.py`` and optax's
``cosine_decay_schedule``).

``cyclic_cosine_decay`` reproduces the reference's ``CyclicCosineDecayLR``
(``cnf/utils/train.py:556-676``): an initial cosine decay over
``init_decay_epochs`` down to ``min_decay_lr``, then either fixed restarts
of ``restart_interval`` epochs (optionally growing geometrically by
``restart_interval_multiplier``) at ``restart_lr``, or a constant tail.
"""

from __future__ import annotations

import math
from typing import Callable


def _cos(frac: float, lo: float, hi: float) -> float:
    return lo + (hi - lo) * (1 + math.cos(math.pi * frac)) / 2


def cyclic_cosine_decay(init_lr: float, init_decay_epochs: int, min_decay_lr: float,
                        restart_interval: int | None = None,
                        restart_interval_multiplier: float | None = None,
                        restart_lr: float | None = None) -> Callable[[int], float]:
    restart_lr = restart_lr if restart_lr is not None else init_lr

    def schedule(step) -> float:
        step = float(step)
        if step < init_decay_epochs:
            return _cos(min(max(step / init_decay_epochs, 0.0), 1.0), min_decay_lr, init_lr)
        if restart_interval is None:
            return min_decay_lr
        t = step - init_decay_epochs
        if restart_interval_multiplier is None:
            return _cos((t % restart_interval) / restart_interval, min_decay_lr, restart_lr)
        # geometric cycle lengths L, L*m, L*m^2, ...: cycle n starts at
        # L*(m^n - 1)/(m - 1)
        m = restart_interval_multiplier
        n = math.floor(math.log(max(t * (m - 1) / restart_interval + 1, 1.0)) / math.log(m))
        start = restart_interval * (m ** n - 1) / (m - 1)
        frac = min(max((t - start) / (restart_interval * m ** n), 0.0), 1.0)
        return _cos(frac, min_decay_lr, restart_lr)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``init_value`` at step 0, cosine
    down to ``alpha * init_value`` at ``decay_steps``, constant after."""
    if decay_steps <= 0:
        raise ValueError("decay_steps must be positive")

    def schedule(step) -> float:
        frac = min(float(step), decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    return schedule
