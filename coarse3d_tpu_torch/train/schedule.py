"""Per-iteration learning-rate schedules as plain ``step -> lr`` functions.

Port of the JAX package's ``train/schedule.py`` (optax schedules there).
Behavioral model: the reference's WarmupCosineLR (utils/warmup_lr.py:55-107)
as the trainer configures it (trainer.py:135-144): linear 0 -> lr over the
warmup steps, then cosine annealing to 0, stepped every iteration.

Each function gives the learning rate of the update made at optimizer step
``step`` (0-based), as optax evaluates its schedule at the count before the
update: the first update runs at lr 0. :func:`lr_lambda` turns a schedule
into the multiplier ``torch.optim.lr_scheduler.LambdaLR`` takes.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``steps``, then end."""

    def schedule(step: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules: ``then`` from ``boundary`` on, counted from it."""

    def schedule(step: int) -> float:
        return first(step) if step < boundary else then(step - boundary)

    return schedule


def warmup_cosine_schedule(lr: float, warmup_steps: int, total_steps: int
                           ) -> Schedule:
    warmup_steps = max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)

    def cosine(step: int) -> float:
        count = min(step, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return _join(_linear(0.0, lr, warmup_steps), cosine, warmup_steps)


def warmup_exp_schedule(lr: float, warmup_steps: int, decay: float
                        ) -> Schedule:
    """Legacy WarmupLR (utils/warmup_lr.py:6-52): linear warmup to lr, then
    lr * decay^step exponential decay."""
    warmup_steps = max(warmup_steps, 1)
    return _join(_linear(0.0, lr, warmup_steps),
                 lambda step: lr * decay ** step, warmup_steps)


def warmup_multistep_schedule(lr: float, warmup_steps: int,
                              milestones: tuple[int, ...], gamma: float = 0.1
                              ) -> Schedule:
    """WarmupMultiStepLR analog (utils/lr_scheduler.py:9-57): after the
    warmup, lr scaled by gamma at each milestone reached."""
    warmup_steps = max(warmup_steps, 1)

    def piecewise(step: int) -> float:
        value = lr
        for m in sorted(set(milestones)):
            if step >= m:
                value *= gamma
        return value

    return _join(_linear(0.0, lr, warmup_steps), piecewise, warmup_steps)


def poly_schedule(lr: float, total_steps: int, power: float = 0.9
                  ) -> Schedule:
    """PolyOptimizer analog (utils/lr_scheduler.py:59-83):
    lr * (1 - step/total)^power."""

    def schedule(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return lr * (1.0 - frac) ** power

    return schedule


def clipped_schedule(base: Schedule, min_lr: float) -> Schedule:
    """ClipLR analog (utils/lr_scheduler.py:85-...): floor the LR."""
    return lambda step: max(base(step), min_lr)


def lr_lambda(schedule: Schedule, base_lr: float) -> Callable[[int], float]:
    """Multiplier of ``base_lr`` for ``LambdaLR``: its ``last_epoch`` counts
    optimizer steps taken, so update n runs at ``schedule(n)``."""
    if base_lr <= 0:
        raise ValueError(f"base_lr must be > 0, got {base_lr}")
    return lambda step: schedule(step) / base_lr
