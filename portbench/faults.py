"""Faults planted under the timed path, for the test that shows ``correct``
comes out false when the path is broken, and for reading each fault's
numbers on the chip (``python3 -m portbench.control --what <name>``).

  unchanged    the train step leaves the weights and the optimizer as they were
  half         half of the batch left out: the train step's mean over the
               first half only; detection of the first half only, the rest
               with no detections
  no_exchange  the data-parallel optimizer skips its gradient all-reduce
  altered      every detection's class moved to the next foreground class
  emptied      detection of the whole batch, then the second half's
               detections dropped
"""

from __future__ import annotations

TRAIN = ("unchanged", "half", "no_exchange")
DETECT = ("half", "altered", "emptied")


def plant(name: str, fn, spec: dict, opt=None):
    """``fn`` (a detect function, or a train step with its optimizer
    ``opt``) of configuration ``spec`` with the fault ``name`` planted."""
    if opt is not None:
        return _train(name, fn, opt)
    return _detect(name, fn, spec["num_classes"] - 1)


def _train(name: str, step, opt):
    if name == "unchanged":
        opt.step = lambda: None
        return step
    if name == "no_exchange":
        opt._data_mean = lambda grads: grads
        return step
    if name == "half":
        def half(batch, draws, mark=None):
            n = batch["image"].shape[0] // 2
            return step({k: v[:n] for k, v in batch.items()},
                        type(draws)(*(t[:n] for t in draws)), mark)
        return half
    raise ValueError(f"no train fault {name!r}")


def _detect(name: str, det, foreground: int):
    import torch

    if name == "half":
        def half(images, img_hw):
            n = len(images) // 2
            d = det(images[:n], img_hw[:n])
            return type(d)(*(torch.cat([t, torch.zeros_like(t)]) for t in d))
        return half
    if name == "altered":
        def altered(images, img_hw):
            d = det(images, img_hw)
            return d._replace(classes=(d.classes + 1) % foreground)
        return altered
    if name == "emptied":
        def emptied(images, img_hw):
            d = det(images, img_hw)
            n = len(images) // 2
            return type(d)(*(torch.cat([t[:n], torch.zeros_like(t[n:])]) for t in d))
        return emptied
    raise ValueError(f"no detect fault {name!r}")
