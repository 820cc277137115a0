"""Learning-rate phase schedules.

Counterpart of faster_rcnn_tpu/train/schedule.py: phases parsed from strings
like "60000:1e-3,20000:1e-4" (args_util.py:30-45) become one
piecewise-constant function of the step count.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple


def phases_from_str(s: str) -> List[Tuple[int, float]]:
    """"60000:1e-3,20000:1e-4" -> [(60000, 1e-3), (20000, 1e-4)]."""
    phases = []
    for part in s.split(","):
        iters, lr = part.split(":")
        phases.append((int(iters), float(lr)))
    return phases


def schedule_from_phases(phases: Sequence[Tuple[int, float]]) -> Callable[[int], float]:
    """step -> the learning rate of the phase the step falls in (the last
    phase's rate from its start on), over cumulative phase boundaries."""
    bounds, total = [], 0
    for iters, _ in phases[:-1]:
        total += iters
        bounds.append(total)
    rates = [lr for _, lr in phases]

    def lr(step: int) -> float:
        return rates[sum(step >= b for b in bounds)]

    return lr


def total_iterations(phases: Sequence[Tuple[int, float]]) -> int:
    return sum(i for i, _ in phases)
