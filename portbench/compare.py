"""The numbers that decide ``correct``: how far the system's outputs lie from
the plain reference's on the same inputs.

Detection: each detection is judged by the reference on the proposals the
system used (:func:`det_gaps`), so that a greedy NMS choice that a rounding
flips judges no detection wrong, while a wrong score, box or class does.

Training: each step's total loss; each trained weight's first SGD trace
(the clipped first gradient) and its change over the followed steps, by
the gap of their norms over the reference's norm of that weight or of the
median weight, whichever is larger, worst weight first.
"""

from __future__ import annotations

import numpy as np
import torch

def log_odds(p):
    p = p.double().clamp(1e-7, 1 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def det_gaps(got, roi_prob, roi_boxes) -> dict:
    """Each of the system's detections judged by the reference on the same
    proposals, as a served token is judged by its logit. A detection of
    class c is matched to the proposal whose class-c box (the reference's)
    lies nearest it; it reads the gap of its box from that box over the
    box's larger side, and the gap of its score from the reference's
    probability of c there, in log-odds (a score is a softmax probability,
    whose rounding error is the logits' times p(1-p)). ``got`` is (boxes
    (B, D, 4), scores, classes, valid) on the CPU; ``roi_prob`` (B, R, C),
    ``roi_boxes`` (B, R, C-1, 4) the reference's. Returns every
    detection's ``score`` and ``box`` gaps, and each image's ``count``."""
    boxes, scores, classes, valid = got
    out = {"score": [], "box": [], "count": []}
    for i in range(boxes.shape[0]):
        v = valid[i].bool()
        b, s, c = boxes[i][v].float(), scores[i][v].float(), classes[i][v].long()
        out["count"].append(int(v.sum()))
        if not len(c):
            continue
        if int(c.min()) < 0 or int(c.max()) >= roi_boxes.shape[2] or not torch.isfinite(b).all():
            out["score"].append(float("inf"))
            out["box"].append(float("inf"))
            continue
        cand = roi_boxes[i].float().permute(1, 0, 2)[c]            # (D, R, 4)
        side = torch.maximum(cand[..., 2] - cand[..., 0],
                             cand[..., 3] - cand[..., 1]).clamp_min(1.0)
        box_gap = (cand - b[:, None, :]).abs().amax(-1) / side      # (D, R)
        r = box_gap.argmin(-1)
        d = torch.arange(len(c))
        out["box"] += box_gap[d, r].tolist()
        out["score"] += (log_odds(s) - log_odds(roi_prob[i][r, c])).abs().tolist()
    return out


def loss_gap(got: list, want: list) -> float:
    """Worst step's |loss - reference loss| / |reference loss|."""
    return max(abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got, want))


def norm_gaps(got: dict, want: dict, names) -> dict:
    """Per weight, from norms by name: |got - want| / max(want, the median
    weight's want)."""
    med = float(np.median([want[k] for k in names]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in names}


def moved(first_norms: dict, names) -> list:
    """The weights whose reference first gradient's norm is at least a
    thousandth of the median weight's: the others move by round-off alone."""
    med = float(np.median([first_norms[k] for k in names]))
    return [k for k in names if first_norms[k] >= 1e-3 * med]


def worst(gaps: dict):
    k = max(gaps, key=gaps.get)
    return gaps[k], k
