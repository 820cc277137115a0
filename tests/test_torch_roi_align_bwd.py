"""The K1 backward kernel's algorithm (faster_rcnn_tpu_torch/csrc/roi_align.cu,
``roi_align_bwd_kernel``) as a numpy model, against the JAX VJP (through the
Pallas kernel in interpret mode) and the port's plain version, on the CPU.

The kernel runs only on a card; this model repeats its steps so that the
algorithm is checked here: one block per (image, map row y, chunk of 32
16-byte vectors of channels); an image's ROIs in batches of
``rois_per_batch``, in r order, each column's sum carried from one batch to
the next; per batch, the row taps of cells 0 and P-1 as the bound
that sends most ROIs away; at most one hit per (r, i) on row y, in (r, i)
order, of weight 1 - frac (lo tap), frac (hi tap, none at frac == 0) or
(1 - frac) + frac where lo == hi; each hit's entries for j = 0..P-1, lo
column before hi column, merged in the same way where they coincide, each
weighing wy * wx; per column its entries in that order, added to the
carried sum with one f32 multiply and one f32 add each, except that a
column holding more than BWD_HEAVY of the batch's entries and more than
1/BWD_WARPS of its row's is cut into BWD_WARPS equal runs, the first from
the carried sum, whose sums are added in run order; every pixel written
once, rounded once to the map's dtype. The kernel's cut of a row's columns
into tiles, where the carried sums do not fit one block, changes no sum,
so the model has none. With no FMA in the kernel's
sums (``__fmul_rn``/``__fadd_rn``) the model gives its bits, so the GPU
tests hold the kernel to it bit for bit.

The file imports JAX only inside the test that compares with it, so that
tests/test_torch_gpu.py can use the model where JAX is not installed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from faster_rcnn_tpu_torch.ops import roi_align_cuda
from faster_rcnn_tpu_torch.ops.roi_align_taps import (BWD_HEAVY, BWD_WARPS, entries_per_column,
                                                      row_hits)

F32 = np.float32
SOURCE = Path(__file__).resolve().parents[1] / "faster_rcnn_tpu_torch" / "csrc" / "roi_align.cu"
CHUNK_VECS = 32  # 16-byte vectors of channels in a block: one a lane
# the source's constants (test_the_model_reads_the_sources_layout)
BWD_ROI_BATCH, BWD_BATCH_BYTES = 128, 98304


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def taps(i: int, start, crop, p: int, limit: int):
    """The kernel's taps(): (lo, hi, frac) of output cell i, in f32."""
    src = F32(i) * (crop / F32(p))
    lo = np.floor(src)
    frac = src - lo
    lo_abs = np.fmin(np.fmax(lo + start, F32(0)), F32(limit - 1))
    hi_abs = np.fmin(np.fmax(np.fmin(lo + F32(1), crop - F32(1)) + start, F32(0)), F32(limit - 1))
    return int(lo_abs), int(hi_abs), frac


def tap_weights(lo: int, hi: int, f):
    """[(index, weight)] of one cell's two taps, as the kernel takes them:
    the lo tap's 1 - frac, the hi tap's frac (none at 0), one (1 - frac) +
    frac where they coincide."""
    if f == 0:
        return [(lo, F32(1) - f)]
    if hi == lo:
        return [(lo, (F32(1) - f) + f)]
    return [(lo, F32(1) - f), (hi, f)]


def rois_per_batch(r: int, p: int) -> int:
    """The kernel's bwd_plan: the ROIs a batch takes."""
    return min(r, BWD_ROI_BATCH, max(1, BWD_BATCH_BYTES // (p * 16 + p * p * 12)))


def kernel_model(grad: np.ndarray, rois: np.ndarray, h: int, w: int, vn: int):
    """(B, R, P, P, C) f32 cotangent, (B, R, 4) f32 ROIs, the map's H and W,
    and the channels of a 16-byte vector (8 for bf16, 4 for f32) -> the f32
    sums the kernel rounds to the map's dtype, and how often each map value
    was written."""
    b_, r_, p, _, c = grad.shape
    nvec = c // vn
    rb = rois_per_batch(r_, p)
    out = np.full((b_, h, w, c), np.nan, F32)
    writes = np.zeros((b_, h, w, c), np.int32)
    for b in range(b_):
        x1, y1 = rois[b, :, 0], rois[b, :, 1]
        crop_w, crop_h = rois[b, :, 2] - x1, rois[b, :, 3] - y1
        col = [[taps(j, x1[r], crop_w[r], p, w) for j in range(p)] for r in range(r_)]
        row = [[taps(i, y1[r], crop_h[r], p, h) for i in range(p)] for r in range(r_)]
        # the bound on a ROI's rows: the taps of its first and last cell
        ends = [taps(0, y1[r], crop_h[r], p, h)[:2] + taps(p - 1, y1[r], crop_h[r], p, h)[:2]
                for r in range(r_)]
        for chunk in range(-(-nvec // CHUNK_VECS)):
            vecs = range(chunk * CHUNK_VECS, min((chunk + 1) * CHUNK_VECS, nvec))
            cs = np.arange(vecs[0] * vn, (vecs[-1] + 1) * vn)
            for y in range(h):
                carry = np.zeros((w, cs.size), F32)  # each column's sum so far
                for r0 in range(0, r_, rb):
                    per_col = [[] for _ in range(w)]  # (r, i, j, weight) in the kernel's order
                    for r in range(r0, min(r_, r0 + rb)):
                        if not min(ends[r]) <= y <= max(ends[r]):
                            continue
                        for i, (lo, hi, f) in enumerate(row[r]):
                            wy = [wt for t, wt in tap_weights(lo, hi, f) if t == y]
                            if not wy:
                                continue
                            for j, (clo, chi, fx) in enumerate(col[r]):
                                for x, wx in tap_weights(clo, chi, fx):
                                    per_col[x].append((r, i, j, wy[0] * wx))
                    n_row = sum(len(e) for e in per_col)
                    for x, ents in enumerate(per_col):
                        n = len(ents)
                        split = n > BWD_HEAVY and n * BWD_WARPS > n_row
                        runs = ([(n * k // BWD_WARPS, n * (k + 1) // BWD_WARPS)
                                 for k in range(BWD_WARPS)] if split else [(0, n)])
                        acc = None
                        for k, (lo_e, hi_e) in enumerate(runs):
                            part = carry[x] if k == 0 else np.zeros(cs.size, F32)
                            for r, i, j, wt in ents[lo_e:hi_e]:
                                part = part + grad[b, r, i, j, cs] * wt
                            acc = part if acc is None else acc + part
                        carry[x] = acc
                out[b, y][:, cs] = carry
                writes[b, y][:, cs] += 1
    return out, writes


def model_bf16(grad: np.ndarray, rois: np.ndarray, h: int, w: int) -> torch.Tensor:
    """The bf16 kernel: bf16 cotangent values summed in f32, rounded once."""
    g16 = torch.from_numpy(grad).bfloat16().float().numpy()
    return torch.from_numpy(kernel_model(g16, rois, h, w, 8)[0]).bfloat16()


def roi_case(kind: str, seed: int = 0):
    """Seeded (B, H, W, C), (B, R, 4) f32 ROIs and the (B, R, 7, 7, C) f32
    cotangent of one edge case of the backward."""
    rng = np.random.RandomState(seed)
    b, h, w, c, r = 2, 4, 6, 16, 12  # tiny_config's map: a 64x96 canvas at stride 16
    if kind == "chunks_and_many_rois":
        # 2 (bf16) and 3 (f32) channel chunks, the last of 1 and 2 vectors;
        # 300 ROIs: batches of 128, 128 and 44, whose rows hold more entries
        # than a batch's buffer (128 P P), taken in two rounds
        h, w, c, r = 3, 40, 264, 300
    elif kind == "vgg_channels":
        # a VGG16 map's 512 channels: each row in two chunks of 256 bf16
        # channels (four of 128 f32), each listing and sorting the row again
        c, r = 512, 24
    elif kind == "rois_512_wide":
        # 512 ROIs (four batches), common in ROI heads; on the card a bf16
        # row's carried sums need 140 KB, more than fits beside a batch, so
        # its columns go to two blocks (tiles of 129)
        h, w, c, r = 3, 140, 8, 512
    x1 = rng.randint(0, w - 1, (b, r))
    y1 = rng.randint(0, h - 1, (b, r))
    x2 = np.minimum(x1 + rng.randint(1, w, (b, r)), w)
    y2 = np.minimum(y1 + rng.randint(1, h, (b, r)), h)
    rois = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    if kind == "repeated":  # drawn with replacement, as the sampler draws
        rois[:, r // 2:] = rois[:, :r - r // 2]
        rois[1] = rois[1, rng.randint(0, 3, r)]
    elif kind == "small_crops":  # crop < 7 in each axis: several i share a row, lo == hi
        h, w = 8, 10
        sizes = [(1, 1), (1, 3), (2, 1), (2, 3), (3, 2), (6, 5), (1, 6), (4, 4)]
        for k in range(r):
            cw, ch = sizes[k % len(sizes)]
            rois[:, k] = [x1[0, k] % (w - cw + 1), y1[0, k] % (h - ch + 1), 0, 0]
            rois[:, k, 2:] = rois[:, k, :2] + [cw, ch]
    elif kind == "zero_frac":  # crop a multiple of 7: frac == 0, the hi taps weigh 0
        h, w = 15, 16
        for k in range(r):
            cw, ch = 7 * (1 + k % 2), 7 * (1 + (k // 2) % 2)
            rois[:, k] = [k % (w - cw + 1), (k * 3) % (h - ch + 1), 0, 0]
            rois[:, k, 2:] = rois[:, k, :2] + [cw, ch]
    elif kind == "last_row_and_column":
        edge = [[w - 1, h - 1, w, h], [w - 2, h - 2, w, h], [w - 3, 0, w, h], [0, h - 2, w, h],
                [w - 2, h - 3, w + 2, h + 3], [w - 5, h - 4, w - 1, h - 1]]
        rois[:, :len(edge)] = edge
    elif kind == "untouched_rows":  # rows 2..H-1 and columns 3..W-1 take no tap
        rois[..., 0] = x1 % 3
        rois[..., 2] = rois[..., 0] + 1
        rois[..., 1] = 0
        rois[..., 3] = 2
    elif kind == "hot_row":  # every ROI the same, smaller than 7x7: one hot row pair
        rois[:] = [1, 1, 3, 3]
    elif kind == "flat_rois":  # 1 row tall, 10 wide: row 1 holds more entries than R P P
        w = 12
        rois[:] = [[k % 3, 1, k % 3 + 10, 2] for k in range(r)]
    elif kind not in ("sampled", "vgg_channels", "chunks_and_many_rois", "rois_512_wide"):
        raise ValueError(kind)
    g = rng.standard_normal((b, r, 7, 7, c)).astype(np.float32)
    return (b, h, w, c), rois, g


CASES = ["sampled", "repeated", "small_crops", "zero_frac", "last_row_and_column",
         "untouched_rows", "hot_row", "flat_rois", "vgg_channels", "chunks_and_many_rois",
         "rois_512_wide"]


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_vjp(g: np.ndarray, rois: np.ndarray, shape) -> np.ndarray:
    """The JAX package's backward: the VJP of roi_align_pallas (interpret
    mode), image by image."""
    import jax
    import jax.numpy as jnp

    from faster_rcnn_tpu.ops.roi_align_pallas import roi_align_pallas

    out = []
    for i in range(shape[0]):
        _, vjp = jax.vjp(lambda f: roi_align_pallas(f, jnp.asarray(rois[i]), 7, True),
                         jnp.zeros(shape[1:], jnp.float32))
        out.append(np.asarray(vjp(jnp.asarray(g[i]))[0]))
    return np.stack(out)


@pytest.mark.parametrize("kind", CASES)
def test_model_matches_jax_vjp_and_plain_version(kind):
    """f32 within 1e-5 of max|ref| of the JAX VJP and of the plain version
    (only the order of the f32 sums differs); every map value written once,
    untouched pixels exactly zero; the bf16 kernel's channel tiling gives
    the f32 tiling's sums bit for bit; bf16 within one rounding of the plain
    version's."""
    shape, rois, g = roi_case(kind)
    b, h, w, c = shape
    got, writes = kernel_model(g, rois, h, w, 4)
    assert (writes == 1).all()
    want = _jax_vjp(g, rois, shape)
    assert _max_rel(got, want) <= 1e-5
    plain = roi_align_cuda.roi_align_backward(torch.from_numpy(g), torch.from_numpy(rois), shape, 7)
    assert _max_rel(got, plain.numpy()) <= 1e-5
    assert not got[want == 0].any()
    got8, writes8 = kernel_model(g, rois, h, w, 8)
    assert (writes8 == 1).all() and np.array_equal(got8.view(np.int32), got.view(np.int32))

    g16 = torch.from_numpy(g).bfloat16()
    plain16 = roi_align_cuda.roi_align_backward(g16, torch.from_numpy(rois), shape, 7)
    assert plain16.dtype == torch.bfloat16
    bf = model_bf16(g, rois, h, w)
    assert _max_rel(bf.float().numpy(), plain16.float().numpy()) <= 1e-2
    if kind == "untouched_rows":
        assert not got[:, 2:].any() and not got[:, :, 3:].any() and got[:, :2, :3].all()
    if kind == "hot_row":
        hits = row_hits(torch.from_numpy(rois), h, 7)
        # crop 2: i = 0..3 take row 1 (lo); i = 1..3 row 2 (hi; i = 0's hi tap
        # weighs 0) and i = 4..6 row 2 once (lo == hi)
        assert hits[:, 1].tolist() == [12 * 4] * 2 and hits[:, 2].tolist() == [12 * 6] * 2
        assert hits[:, 3:].sum() == 0 and hits[:, 0].sum() == 0


def test_row_hits_counts_the_kernels_hits():
    """roi_align_taps.row_hits (what chip_smoke.check_roi_align_bwd reports)
    counts the hits the kernel's blocks find on each row: one per (r, i)
    with a tap of nonzero weight there."""
    shape, rois, _ = roi_case("small_crops", seed=3)
    _, h, w, _ = shape
    want = np.zeros((shape[0], h), np.int64)
    for b in range(shape[0]):
        for x1, y1, x2, y2 in rois[b]:
            for i in range(7):
                for yy, _ in tap_weights(*taps(i, y1, y2 - y1, 7, h)):
                    want[b, yy] += 1
    assert np.array_equal(row_hits(torch.from_numpy(rois), h, 7), want)


def test_the_model_reads_the_sources_layout():
    """The model's channel chunk, ROI batches and split rule are the
    kernel's, and the backward has no atomic on global memory and no
    memset."""
    src = SOURCE.read_text()
    bwd = src[src.index("// Backward."):src.index("}  // namespace")]
    assert "const int v0 = blockIdx.x / H % chunks * 32, v = v0 + lane;" in bwd
    assert "const int nvec = C / VN, chunks = (nvec + 31) / 32;" in bwd
    assert "const int chunks = (C / Vec16<T>::N + 31) / 32, tiles" in bwd
    for name, value in [("BWD_WARPS", BWD_WARPS), ("BWD_HEAVY", BWD_HEAVY),
                        ("BWD_ROI_BATCH", BWD_ROI_BATCH), ("BWD_BATCH_BYTES", BWD_BATCH_BYTES)]:
        assert re.search(rf"constexpr int {name} = {value};", bwd), name
    assert "const size_t per_roi = (size_t)P * 16 + (size_t)P * P * 12;" in bwd
    assert "for (int r0 = 0; r0 < R; r0 += RB) {" in bwd
    assert "split = in && n > BWD_HEAVY && n * BWD_WARPS > total;" in bwd
    assert re.findall(r"atomic\w*\(([^,]*)", bwd) == ["&count[xs[k]]", "&next_col"]
    assert "cudaMemsetAsync" not in src


@pytest.mark.parametrize("scale", [0.3, 1.0, 7.0, 40.0])
def test_first_and_last_cells_bound_every_row_tap(scale):
    """The kernel sends a ROI away when row y lies outside the taps of its
    cells 0 and P-1; both taps are monotone in the cell, so no ROI with a
    tap on y is sent away, for integer, fractional, empty and inverted
    crops and ROIs that leave the map."""
    rng = np.random.RandomState(int(scale * 10))
    for y1, crop in zip(rng.uniform(-5, 45, 300).astype(F32),
                        (rng.uniform(-0.5, 1, 300) * scale).astype(F32)):
        if scale == 1.0:
            y1, crop = np.floor(y1), np.floor(crop * 8)
        ends = taps(0, y1, crop, 7, 38)[:2] + taps(6, y1, crop, 7, 38)[:2]
        for i in range(7):
            lo, hi, _ = taps(i, y1, crop, 7, 38)
            assert min(ends) <= lo <= max(ends) and min(ends) <= hi <= max(ends)


@pytest.mark.parametrize("kind", ["sampled", "small_crops", "hot_row"])
def test_bench_counts_the_models_entries(kind):
    """roi_align_taps.entries_per_column's count of the entries a pixel
    takes (what scripts/bench_roi_align_bwd_cuda.py reports and PERF.md
    quotes) is the model's: totals, largest column and the columns split
    over the warps."""
    shape, rois, _ = roi_case(kind)
    b_, h, w, _ = shape
    ent = np.zeros((b_, h, w), np.int64)
    for b in range(b_):
        for x1, y1, x2, y2 in rois[b]:
            for i in range(7):
                for y, _ in tap_weights(*taps(i, y1, y2 - y1, 7, h)):
                    for j in range(7):
                        for x, _ in tap_weights(*taps(j, x1, x2 - x1, 7, w)):
                            ent[b, y, x] += 1
    row = ent.sum(2, keepdims=True)
    got = entries_per_column(torch.from_numpy(rois), h, w, 7)["merged"]
    assert got == {"total": int(ent.sum()), "max_column": int(ent.max()),
                   "max_row": int(row.max()),
                   "split_columns": int(((ent > BWD_HEAVY) & (ent * BWD_WARPS > row)).sum())}
