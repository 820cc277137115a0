"""A cell's files cut to a size the CPU runs in seconds, for the tests:
a 160x384 canvas holding a 150x370 frame, two images a call or step."""

from __future__ import annotations

import copy
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def found(cell: str, batch: int = 2) -> dict:
    f = copy.deepcopy(harness.find_cell(ROOT, cell))
    f["spec"].update(canvas_h=160, canvas_w=384, frame_h=150, frame_w=370)
    f["mix"].update(batch=batch, distinct_batches=3, sampled_calls=2, trace_calls=2,
                    trace_steps=2, read_every=2, followed_steps=2)
    if "box_w" in f["mix"]:
        f["mix"].update(box_w=[10, 100], box_h=[10, 80])
    return f


def ctx(cell: str, batch: int = 2, seconds: float = 0.5, trace: bool = False, fault=None,
        seed: int = 2 ** 31 + 12345):
    import torch
    return harness.Ctx(found(cell, batch), seed, seconds, trace, torch.device("cpu"),
                       fault=fault)
