"""Joint training: ``batch`` images a step (the global batch, split over
the ranks of a data-parallel cell), round-robin over ``distinct_batches``
seeded batches resident on the device as the device cache holds them, the
samplers' draws made for every step from the seed, the losses read to the
host every ``read_every`` steps as ``train_cached``'s chunks do. The first
``followed_steps`` steps run in set-up and are the ones the reference
follows; the window goes on from there with the same step, model and
optimizer."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
import torch.distributed as dist

from portbench import compare, harness, inputs, weights
from portbench.modes.detect import proposal_diffs
from portbench.reference import ops, paths


def _rows(ctx):
    lb = ctx.mix["batch"] // ctx.world
    return slice(ctx.rank * lb, (ctx.rank + 1) * lb)


def _draws(ctx, step: int, draws_type):
    d = inputs.draws(ctx.spec, ctx.mix["batch"], ctx.seed, step, ctx.device, draws_type)
    return draws_type(*(t[_rows(ctx)].contiguous() for t in d))


def _batch(ctx, index: int) -> dict:
    full = inputs.train_batch(ctx.spec, ctx.mix, ctx.seed, index, ctx.device)
    return {k: v[_rows(ctx)].contiguous() for k, v in full.items()}


def setup(ctx):
    from portbench import port
    spec, mix, dev = ctx.spec, ctx.mix, ctx.device
    m = port.model(spec, weights.make_weights(spec, ctx.seed, dev), dev)
    step, opt = port.train_step(spec, m, dev, data_parallel=ctx.world > 1)
    step = ctx.fault_wrap(step, opt=opt)
    batches = [_batch(ctx, i) for i in range(mix["distinct_batches"])]
    losses, props = [], []
    with port.ProposalTap() as tap:
        for s in range(mix["followed_steps"]):
            out = step(batches[s], _draws(ctx, s, port.Draws))
            losses.append({k: float(v) for k, v in out.items() if k != "num_valid_images"})
            if s == 0:
                first = {k: float(t.norm()) for k, t in port.optimizer_traces(opt).items()}
    props = tap.calls
    after = {k: p.detach().clone() for k, p in m.named_parameters()
             if k in set(port.trained_names(opt))}
    ctx.sync()
    return {"model": m, "step": step, "opt": opt, "batches": batches, "port": port,
            "losses": losses, "first_norms": first, "after": after, "props": props}


def window(ctx, st) -> dict:
    mix, step, batches, port = ctx.mix, st["step"], st["batches"], st["port"]
    enq = []
    s = mix["followed_steps"]
    ctx.sync()
    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    start = time.perf_counter()
    done = 0
    while True:
        dr = _draws(ctx, s, port.Draws)
        t0 = time.perf_counter()
        out = step(batches[s % len(batches)], dr)
        enq.append(time.perf_counter() - t0)
        s += 1
        done += 1
        if done % mix["read_every"] == 0:
            float(out["loss"])
            stop = torch.tensor([int(time.perf_counter() - start >= ctx.seconds)],
                                device=ctx.device)
            if ctx.world > 1:
                dist.broadcast(stop, 0)
            if bool(stop):
                break
    ctx.sync()
    elapsed = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.on_card else 0
    tracer = None
    if ctx.trace:  # after the window: the profiler's own work stays out of it
        tracer = harness.Tracer(ctx, mix["trace_steps"])
        for j in range(mix["trace_steps"]):
            dr = _draws(ctx, s + j, port.Draws)
            tracer.before(j)
            out = step(batches[(s + j) % len(batches)], dr, tracer.mark)
            tracer.after(j)
    images = done * mix["batch"]
    return {"steps": done, "elapsed": elapsed, "peak": peak, "enq": enq, "tracer": tracer,
            "images": images,
            "e2e": {"train_img_per_s": images / elapsed},
            "stats": {"steps": done, "step_median_ms": elapsed / done * 1e3}}


def check(ctx, st, win) -> dict:
    """The followed steps against the reference's (:func:`judge`)."""
    out = {k: st[k] for k in ("losses", "first_norms", "after", "props")}
    st.clear()
    gc.collect()
    if ctx.on_card:
        torch.cuda.empty_cache()
    return judge(ctx, out)


def followed_inputs(ctx):
    """(weights, batches, draws) of the followed steps, made anew."""
    n = ctx.mix["followed_steps"]
    return (weights.make_weights(ctx.spec, ctx.seed, ctx.device),
            [_batch(ctx, i) for i in range(n)],
            [_draws(ctx, s, ops.Draws) for s in range(n)])


def judge(ctx, got: dict) -> dict:
    """The numbers of a system's followed steps (``got``: ``losses``, each
    trained weight's ``first_norms`` of its first SGD trace, its weights
    ``after`` the steps, and each step's ``props``) against the reference
    following the same proposals: each step's loss; the first trace's norm
    and the weights' change, by weight, the worst weight's gap and the
    median weight's; and each step's proposals against the
    reference's on the step's own RPN outputs, where ``props`` holds those
    outputs. A number that cannot be read is inf."""
    spec = ctx.spec
    paths.no_tf32()
    props = got["props"]
    out = {k: float("inf") for k in ("loss_gap", "grad_gap", "grad_gap_median",
                                     "change_gap_median", "change_gap")}
    out["prop_diff"] = -1
    if len(props) != ctx.mix["followed_steps"]:
        return out
    W0, batches, draws = followed_inputs(ctx)
    if any(p["boxes"].shape[0] != b["image"].shape[0] for p, b in zip(props, batches)):
        return out
    grid = paths.Grid(spec, ctx.device)
    out["prop_diff"] = sum(proposal_diffs(spec, grid, p, b["img_hw"], spec["train_pre_nms"],
                                          spec["train_post_nms"])
                           for p, b in zip(props, batches) if "probs" in p)
    reduce = None
    if ctx.world > 1:
        def reduce(ts):
            for t in ts:
                dist.all_reduce(t)
            return ts
    ref_losses, ref_trace, ref_after, _ = paths.train(
        W0, spec, batches, draws, [(p["boxes"], p["valid"]) for p in props], "f32",
        reduce_grads=reduce, world=ctx.world)
    out["loss_gap"] = compare.loss_gap(got["losses"], ref_losses)
    out["losses"] = [round(x["loss"], 6) for x in got["losses"]]
    out["ref_losses"] = [round(x["loss"], 6) for x in ref_losses]
    names = sorted(ref_trace)
    first, after = got["first_norms"], got["after"]
    ref_first = {k: float(ref_trace[k].norm()) for k in names}
    if sorted(first) == names:
        gaps = compare.norm_gaps(first, ref_first, names)
        out["grad_gap_median"] = float(np.median(list(gaps.values())))
        out["grad_gap"], out["grad_gap_at"] = compare.worst(gaps)
    if sorted(after) != names:
        return out
    keep = compare.moved(ref_first, names)
    got_change = {k: float((after[k].to(ctx.device) - W0[k]).norm()) for k in keep}
    ref_change = {k: float((ref_after[k] - W0[k]).norm()) for k in keep}
    gaps = compare.norm_gaps(got_change, ref_change, keep)
    out["change_gap_median"] = float(np.median(list(gaps.values())))
    out["change_gap"], out["change_gap_at"] = compare.worst(gaps)
    out["left_out"] = len(names) - len(keep)
    return out


def control(ctx, prec: str) -> dict:
    """The reference computed at ``prec``, in the system's place."""
    W0, batches, draws = followed_inputs(ctx)
    losses, trace, after, props = paths.train(W0, ctx.spec, batches, draws, None, prec)
    del W0
    return judge(ctx, {"losses": losses,
                       "first_norms": {k: float(t.norm()) for k, t in trace.items()},
                       "after": after,
                       "props": [{"boxes": b, "valid": v} for b, v in props]})
