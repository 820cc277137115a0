"""A closed-loop detection client: one caller sends ``batch`` host uint8
canvases a call, round-robin over ``distinct_batches`` seeded batches, and
brings each call's detections to the host before the next, as ``cli.detect``
consumes them. Every call is timed from its issue to its detections on the
host; its enqueue (the call's return, before the readback) apart."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare, harness, inputs, weights
from portbench.reference import ops, paths


def setup(ctx):
    from portbench import port
    spec, mix, dev = ctx.spec, ctx.mix, ctx.device
    m = port.model(spec, weights.make_weights(spec, ctx.seed, dev), dev)
    det = port.detect_fn(spec, m, dev)
    batches = [inputs.frames(spec, mix, ctx.seed, i, dev).cpu().numpy()
               for i in range(mix["distinct_batches"])]
    hw = inputs.frame_hw(spec, mix)
    det = ctx.fault_wrap(det)
    for i in range(2):  # every shape of the window: one batch size, one canvas
        det(batches[i], hw).valid.cpu()
    t = time.perf_counter()
    det(batches[0], hw).valid.cpu()
    return {"model": m, "detect": det, "batches": batches, "hw": hw,
            "call_s": time.perf_counter() - t, "port": port}


def window(ctx, st) -> dict:
    mix, det, batches, hw, port = ctx.mix, st["detect"], st["batches"], st["hw"], st["port"]
    rng = np.random.default_rng([int(ctx.seed) % (2 ** 63), 7])
    n_est = max(mix["sampled_calls"], int(0.8 * ctx.seconds / st["call_s"]))
    sample = set(rng.choice(n_est, mix["sampled_calls"], replace=False).tolist())
    lat, enq, kept = [], [], {}
    tap = port.ProposalTap(armed=False)
    ctx.sync()
    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    with tap:
        start = time.perf_counter()
        i = 0
        while True:
            tap.armed = i in sample
            t0 = time.perf_counter()
            d = det(batches[i % len(batches)], hw)
            t1 = time.perf_counter()
            host = (d.boxes.cpu(), d.scores.cpu(), d.classes.cpu(), d.valid.cpu())
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            enq.append(t1 - t0)
            if tap.armed:
                kept[i] = (host, tap.calls[-1] if tap.calls else None)
            i += 1
            if t2 - start >= ctx.seconds:
                break
    elapsed = t2 - start
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.on_card else 0
    b = mix["batch"]
    tracer = None
    if ctx.trace:  # after the window: the profiler's own work stays out of it
        tracer = harness.Tracer(ctx, mix["trace_calls"])
        for j in range(mix["trace_calls"]):
            tracer.before(j)
            det(batches[(i + j) % len(batches)], hw).valid.cpu()
            tracer.after(j)
    return {"calls": i, "elapsed": elapsed, "peak": peak, "lat": lat, "enq": enq, "kept": kept,
            "tracer": tracer, "images": i * b,
            "e2e": {"detect_img_per_s": i * b / elapsed,
                    "detect_p95_ms": harness.quantile(lat, 0.95) * 1e3},
            "stats": {"calls": i, "latency_median_ms": float(np.median(lat)) * 1e3,
                      "latency_samples": len(lat)}}


def check(ctx, st, win) -> dict:
    """The sampled calls against the reference (:func:`judge`)."""
    batches, hw = st["batches"], st["hw"]
    st.clear()
    gc.collect()
    if ctx.on_card:
        torch.cuda.empty_cache()
    return judge(ctx, win["kept"], batches, hw)


def judge(ctx, kept: dict, batches, hw) -> dict:
    """Each kept call's detections against the reference's on the same
    frames, the reference following the call's own proposals; its RPN
    outputs against the reference's; and its proposals against the
    reference's proposals on the call's own RPN outputs; and its detections
    against the reference's decode of the call's own decode inputs, slot by
    slot. ``kept`` maps a call's index to (its detections on the host, its
    proposal stage's record)."""
    spec, dev = ctx.spec, ctx.device
    paths.no_tf32()
    W = weights.make_weights(spec, ctx.seed, dev)
    grid = paths.Grid(spec, dev)
    hw_t = torch.as_tensor(hw, device=dev)
    inf = float("inf")
    rpn, score, box, diffs, decoded = [], [], [], 0, 0
    for i, (host, tapped) in sorted(kept.items()):
        frames = torch.as_tensor(batches[i % len(batches)], device=dev)
        if tapped is None or tapped["boxes"].shape[0] != frames.shape[0]:
            rpn, score, box, decoded = rpn + [inf], score + [inf], box + [inf], inf
            continue
        ref = paths.detect(W, spec, frames, hw_t, "f32", props=(tapped["boxes"], tapped["valid"]))
        rpn += rpn_gaps(tapped, ref)
        g = compare.det_gaps(host, ref["roi_prob"], ref["roi_boxes"])
        score, box = score + g["score"], box + g["box"]
        decoded += decode_diffs(spec, tapped, host, dev)
        diffs += proposal_diffs(spec, grid, tapped, hw_t, spec["infer_pre_nms"],
                                spec["infer_post_nms"])
    # a call with no detection has no score or box to judge, only its RPN,
    # proposals and decode; no call compared reads as not correct
    none = inf if not rpn else 0.0
    return {"rpn_gap": max(rpn, default=inf), "det_score_gap": max(score, default=none),
            "det_box_gap": max(box, default=none), "prop_diff": diffs,
            "decode_diff": decoded if kept else inf,
            "compared_calls": len(kept), "detections": len(score)}


def control(ctx, prec: str) -> dict:
    """The reference computed at ``prec``, in the system's place, on each
    of the mix's distinct batches."""
    spec, mix, dev = ctx.spec, ctx.mix, ctx.device
    paths.no_tf32()
    W = weights.make_weights(spec, ctx.seed, dev)
    hw = inputs.frame_hw(spec, mix)
    batches, kept = [], {}
    for i in range(mix["distinct_batches"]):
        frames = inputs.frames(spec, mix, ctx.seed, i, dev)
        got = paths.detect(W, spec, frames, torch.as_tensor(hw, device=dev), prec)
        batches.append(frames.cpu().numpy())
        kept[i] = (got["dets"], {"probs": got["probs"], "bbreg": got["bbreg"],
                                 "boxes": got["rois"], "valid": got["roi_valid"],
                                 "decode": (got["rois"], got["roi_valid"], got["roi_prob"],
                                            got["roi_reg"])})
    del W
    return judge(ctx, kept, batches, hw)


def rpn_gaps(tapped, ref) -> list:
    """Per image: the RPN outputs' relative L2 gap from the reference's, the
    larger of the objectness's and the boxes'."""
    b = ref["probs"].shape[0]
    out = []
    for key in ("probs", "bbreg"):
        got = tapped[key].float().cpu().reshape(b, -1)
        want = ref[key].reshape(b, -1)
        out.append(((got - want).norm(dim=1) / want.norm(dim=1)).tolist())
    return [max(a, c) for a, c in zip(*out)]


def decode_diffs(spec, tapped, host, dev):
    """Detection slots where the call's returned detections (``host``)
    differ from the reference's decode of the call's own decode inputs:
    a slot's flag, or in a slot both flag, its box, score or class. A call
    whose decode was not recorded reads inf."""
    if "decode" not in tapped:
        return float("inf")
    rois, roi_valid, prob, reg = (t.to(dev) for t in tapped["decode"])
    want_b, want_s, want_c, want_v = ops.final_detections(
        rois, roi_valid, prob, reg, spec["num_classes"], spec["stride"], spec["det_threshold"],
        spec["final_nms_iou"], spec["infer_post_nms"])
    got_b, got_s, got_c, got_v = host
    if got_v.shape != want_v.shape:
        return float("inf")
    got_v = got_v.bool()
    both = got_v & want_v
    off = (got_v != want_v) | (both & ((got_b.float() != want_b).any(-1)
                                       | (got_s.float() != want_s) | (got_c.int() != want_c)))
    return int(off.sum())


def proposal_diffs(spec, grid, tapped, hw_t, pre, post) -> int:
    """Proposal slots (box or flag) where the system's differ from the
    reference's on the system's own RPN outputs."""
    dev = grid.conv.device
    boxes, valid = paths.rpn_proposals(spec, grid, tapped["probs"].float().to(dev),
                                       tapped["bbreg"].float().to(dev), hw_t, pre, post)
    got_b, got_v = tapped["boxes"].to(boxes.device), tapped["valid"].to(boxes.device)
    return int(((got_b != boxes).any(-1) | (got_v != valid)).sum())
