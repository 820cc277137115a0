"""The K1 forward kernel's work split and arithmetic
(faster_rcnn_tpu_torch/csrc/roi_align.cu, ``roi_align_kernel``) as a numpy
model, against the port's plain version and the JAX package, on the CPU.

The kernel runs only on a card; this model repeats what it does so that the
split is checked here: block (r * chunks + chunk, b) takes the cells of
ROI r of image b, for the chunk of K1_VECS 16-byte vectors of channels
[chunk K1_VECS, (chunk + 1) K1_VECS) (chunks = ceil(nvec / K1_VECS)); its
thread (x, y), of K1_VECS x JT (JT = 7 at P = 7, else min(P, 8)), takes
vector v = chunk K1_VECS + x (none past nvec) of columns j = y, y + JT, ...
and runs each column's rows 0..P-1 in order. A cell's value is the three
lerps in the plain version's order, each f32 operation rounded on its own
(no FMA: __fsub_rn, __fmul_rn, __fadd_rn), then one rounding to the map's
dtype; a tap row the row before used keeps its horizontal lerp from there
(reuse_sources), which repeats the same operations on the same values. So
the GPU tests hold the kernel to the plain version bit for bit.
"""

import re

import numpy as np
import pytest
import torch

from chip_smoke import _bits_differing
from faster_rcnn_tpu_torch.ops import roi_align_cuda
from faster_rcnn_tpu_torch.ops.roi_align_taps import forward_loads
from tests.test_torch_roi_align_bwd import SOURCE, taps

F32 = np.float32
# the shapes the paths give the kernel (scripts/bench_roi_align_cuda.py):
# (label, B, R, C) over a 38x94 map (a 608x1504 canvas at stride 16)
PATH_SHAPES = [("annotate", 1, 300, 512), ("step2", 16, 64, 512), ("detect", 16, 300, 1024),
               ("joint", 16, 64, 1024)]
MAP_HW = (38, 94)


def source_constants() -> dict:
    """The forward's constants as the source sets them."""
    src = SOURCE.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("K1_VECS", "K1_GENERIC_WARPS")}


K1 = source_constants()


def warps(p: int) -> int:
    """JT, the warps of a block: one a column at P = 7."""
    return 7 if p == 7 else min(p, K1["K1_GENERIC_WARPS"])


def decode_block(bx: int, nvec: int) -> tuple:
    """(r, chunk) of block index x."""
    chunks = -(-nvec // K1["K1_VECS"])
    return bx // chunks, bx % chunks


def block_items(chunk: int, p: int, nvec: int) -> np.ndarray:
    """(i, j, v) of every output vector a block writes, in the order its
    threads' loops take them: thread (x, y), columns j from y in steps of
    JT, then the rows from 0."""
    jt = warps(p)
    out = [(i, j, chunk * K1["K1_VECS"] + x)
           for y in range(jt) for x in range(K1["K1_VECS"]) if chunk * K1["K1_VECS"] + x < nvec
           for j in range(y, p, jt) for i in range(p)]
    return np.array(out, np.int64).reshape(-1, 3)


def check_written_once(r_: int, p: int, nvec: int) -> None:
    """Every output vector (b, r, i, j, v) is written exactly once: the
    grid's x index names each (r, chunk) once, and an ROI's blocks write
    each of its (i, j, v) once (an image's blocks differ only in
    blockIdx.y, which picks the image)."""
    chunks = -(-nvec // K1["K1_VECS"])
    decoded = {decode_block(bx, nvec) for bx in range(r_ * chunks)}
    assert decoded == {(r, c) for r in range(r_) for c in range(chunks)}
    counts = np.zeros((p, p, nvec), np.int64)
    for chunk in range(chunks):
        np.add.at(counts, tuple(block_items(chunk, p, nvec).T), 1)
    assert (counts == 1).all()


def reuse_sources(lo, hi) -> list:
    """The kernel's choice for the cell rows of one column, from the
    row taps alone: per row (top, bot), top 0 new, 1 kept from the row
    before, 2 the row before's bot; bot 0 new, 2 kept from the row before,
    3 this row's top (lo == hi). Tap rows are compared by index, as the
    kernel compares their map offsets."""
    out, prev_lo, prev_hi = [], -1, -1
    for i in range(len(lo)):
        t = 0 if lo[i] not in (prev_lo, prev_hi) else 2 if lo[i] == prev_hi else 1
        m = 3 if hi[i] == lo[i] else 2 if hi[i] == prev_hi else 0
        out.append((t, m))
        prev_lo, prev_hi = lo[i], hi[i]
    return out


def kernel_model(feat: np.ndarray, rois: np.ndarray, p: int, vn: int, reuse: bool = True):
    """(B, H, W, C) f32 map (bf16 values for the bf16 kernel), (B, R, 4) f32
    ROIs, the pool size and the channels of a 16-byte vector -> the f32
    values the kernel rounds to the map's dtype, (B, R, P, P, C), and how
    often each output vector was written, (B, R, P, P, C // vn). With
    ``reuse`` (the kernel's way), a column's horizontal lerps come from the
    row before where reuse_sources says so; without it, every lerp anew."""
    b_, h, w, c = feat.shape
    r_ = rois.shape[1]
    nvec = c // vn
    chunks = -(-nvec // K1["K1_VECS"])
    out = np.full((b_, r_, p, p, nvec, vn), np.nan, F32)
    writes = np.zeros((b_, r_, p, p, nvec), np.int64)
    vecs = feat.reshape(b_, h, w, nvec, vn)
    items = {chunk: block_items(chunk, p, nvec) for chunk in range(chunks)}
    for b in range(b_):
        for bx in range(r_ * chunks):
            r, chunk = decode_block(bx, nvec)
            x1, y1, x2, y2 = rois[b, r]
            # the row taps in shared memory, the column taps in registers
            row = [np.array(t) for t in zip(*(taps(i, y1, y2 - y1, p, h) for i in range(p)))]
            col = [np.array(t) for t in zip(*(taps(j, x1, x2 - x1, p, w) for j in range(p)))]
            i, j, v = items[chunk].T
            np.add.at(writes, (b, r, i, j, v), 1)
            lanes = np.unique(v)
            for jj in np.unique(j):
                xlo, xhi, fx = col[0][jj], col[1][jj], F32(col[2][jj])

                def lerp_row(y):  # float32 numpy: each operation rounded
                    a, c_ = vecs[b, y, xlo, lanes], vecs[b, y, xhi, lanes]
                    return a + (c_ - a) * fx

                sources = reuse_sources(row[0], row[1]) if reuse else [(0, 0)] * p
                top = bot = None
                for ii, (t, m) in enumerate(sources):
                    top, bot = ((lerp_row(row[0][ii]) if t == 0 else top if t == 1 else bot),
                                (lerp_row(row[1][ii]) if m == 0 else bot if m == 2 else None))
                    bot = top if m == 3 else bot
                    out[b, r, ii, jj, lanes] = top + (bot - top) * F32(row[2][ii])
    return out.reshape(b_, r_, p, p, c), writes


def path_rois(rng, b: int, r: int, h: int, w: int) -> np.ndarray:
    """Integer ROIs as proposals and samples give them (1-40 px wide, 1-20
    tall, inside the map), with the edge cases among them: one-pixel ROIs,
    ROIs on the map's last row and column, a crop that is a multiple of 7
    (frac == 0) and one under 7 (cells sharing taps)."""
    x1 = rng.randint(0, w - 1, (b, r))
    y1 = rng.randint(0, h - 1, (b, r))
    x2 = np.maximum(np.minimum(x1 + rng.randint(1, 40, (b, r)), w), x1 + 1)
    y2 = np.maximum(np.minimum(y1 + rng.randint(1, 20, (b, r)), h), y1 + 1)
    rois = np.stack([x1, y1, x2, y2], -1).astype(F32)
    edge = [[4, 3, 5, 4], [w - 1, h - 1, w, h], [0, h - 1, w, h], [w - 1, 0, w, h],
            [w - 3, h - 2, w, h], [5, 6, 19, 13], [2, 2, 5, 4], [w - 8, h - 8, w - 1, h - 1]]
    rois[:, :len(edge)] = edge[:r]
    return rois


def degenerate_rois(rng, b: int, r: int, h: int, w: int) -> np.ndarray:
    """Integer ROIs the paths do not give but the kernel must take as the
    plain version does: empty and inverted crops, crops of 1 and 2, ROIs
    partly or wholly off the map."""
    x1 = rng.randint(-6, w + 6, (b, r))
    y1 = rng.randint(-6, h + 6, (b, r))
    rois = np.stack([x1, y1, x1 + rng.randint(-9, 12, (b, r)), y1 + rng.randint(-9, 12, (b, r))],
                    -1).astype(F32)
    rois[:, :4] = [[3, 2, 3, 2], [5, 6, 2, 1], [1, 1, 2, 3], [0, 4, 2, 6]]
    return rois


def test_the_model_reads_the_sources_split():
    """The model's loops are the kernel's: the block's ROI and chunk, the
    threads' vectors, columns and rows, the row
    taps in shared memory, the reuse rule, the lerps without FMA and the
    store."""
    src = SOURCE.read_text()
    fwd = src[src.index("template <typename T, int PT>"):src.index("// Backward.")]
    for line in [
        "const int nvec = C / VN, chunks = (nvec + K1_VECS - 1) / K1_VECS;",
        "const int b = blockIdx.y, r = blockIdx.x / chunks, chunk = blockIdx.x % chunks;",
        "for (int k = threadIdx.y * K1_VECS + threadIdx.x; k < P; k += K1_VECS * blockDim.y) {",
        "const Taps t = taps(k, y1, crop_h, P, H);",
        "rows[k] = make_int4(t.lo * W * nvec, t.hi * W * nvec, __float_as_int(t.frac), 0);",
        "const int v = chunk * K1_VECS + threadIdx.x;",
        "if (v >= nvec) return;",
        "for (int j = threadIdx.y; j < P; j += blockDim.y) {",
        "const Taps tx = taps(j, x1, crop_w, P, W);",
        "for (int i = 0; i < P; ++i) {",
        "const int4 ty = rows[i];",
        "const bool top_new = ty.x != prev_lo && ty.x != prev_hi;",
        "const bool bot_new = ty.y != ty.x && ty.y != prev_hi;",
        "constexpr bool load_all = sizeof(T) == 2;",
        "constexpr int row_unroll = load_all && PT > 0 ? PT : 1;",
        "#pragma unroll(row_unroll)",
        "if (load_all || top_new) {",
        "if (load_all || bot_new) {",
        "if (top_new) {",
        "} else if (ty.x == prev_hi) {",
        "for (int k = 0; k < VN; ++k) top[k] = bot[k];",
        "if (bot_new) {",
        "} else if (ty.y == ty.x) {",
        "for (int k = 0; k < VN; ++k) bot[k] = top[k];",
        "prev_lo = ty.x, prev_hi = ty.y;",
        "for (int k = 0; k < VN; ++k) res.v()[k] = from_f32<T>(lerp_rn(top[k], bot[k], fy));",
        "uint4* o = ob + ((size_t)i * P + j) * nvec;",
        "__stcs(o, res.raw);",
        "const dim3 grid(R * chunks, B);",
        "const size_t smem = (size_t)P * sizeof(int4);",
        "roi_align_kernel<T, 7><<<grid, dim3(K1_VECS, 7), smem, (cudaStream_t)stream>>>(",
        "roi_align_kernel<T, 0><<<grid, dim3(K1_VECS, std::min(P, K1_GENERIC_WARPS)), smem,",
    ]:
        assert line in fwd, line
    assert "return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));" in src
    assert len(re.findall(r"lerp_rn\(", fwd)) == 3 and not re.search(r"fmaf?\(|__fmaf", fwd)


@pytest.mark.parametrize("label,b,r,c", PATH_SHAPES)
@pytest.mark.parametrize("vn", [8, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("p", [7, 5])
def test_every_output_vector_is_written_once(label, b, r, c, vn, p):
    """At each path's full shape, in both dtypes (64-256 vectors a cell,
    2-8 chunks), at the paths' pool size and another: each output vector
    once."""
    check_written_once(r, p, c // vn)


@pytest.mark.parametrize("nvec", [8, 250, 64, 18])
def test_other_widths_write_every_output_vector_once(nvec):
    """Widths the paths do not give, at P = 7 and 9 (two columns for some
    warps): 8 vectors (C = 64 bf16), 250 (C = 1000 f32) and 18 (C = 72
    f32), where one chunk is part empty, and 64, two whole chunks."""
    for p in (7, 9):
        check_written_once(3, p, nvec)


@pytest.mark.parametrize("label,b,r,c", PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [7, 5])
def test_model_values_are_the_plain_versions_bits(label, b, r, c, dtype, p):
    """At each path's map (38x94, its C) with 2 images of 10 ROIs (the edge
    cases among them): every output vector written once, and the model's
    values the plain version's (the wrapper's CPU path) bit for bit, in
    bf16 and in f32."""
    rng = np.random.RandomState(c + r + p)
    h, w = MAP_HW
    feat = torch.tensor(rng.standard_normal((2, h, w, c)) * 4, dtype=dtype)
    rois = path_rois(rng, 2, 10, h, w)
    vn = 16 // feat.element_size()
    got, writes = kernel_model(feat.float().numpy(), rois, p, vn)
    assert (writes == 1).all()
    want = roi_align_cuda.roi_align(feat, torch.from_numpy(rois), p)
    assert want.dtype == dtype and want.shape == got.shape
    assert _bits_differing(torch.from_numpy(got).to(dtype), want) == 0
    # the one-pixel ROI is its pixel in every cell
    assert torch.equal(want[0, 0], feat[0, 3, 4].expand(p, p, c))


@pytest.mark.parametrize("p", [7, 10])
def test_model_values_do_not_depend_on_the_reuse(p):
    """The reuse of the row before's lerps repeats the same operations:
    the same bits with and without it, at C = 72 f32 (18 vectors: a chunk
    part empty), on the paths' ROIs and degenerate ones."""
    rng = np.random.RandomState(3)
    feat = rng.standard_normal((1, 9, 13, 72)).astype(F32)
    rois = np.concatenate([path_rois(rng, 1, 9, 9, 13), degenerate_rois(rng, 1, 9, 9, 13)], 1)
    base, _ = kernel_model(feat, rois, p, 4, reuse=False)
    got, writes = kernel_model(feat, rois, p, 4)
    assert (writes == 1).all()
    assert np.array_equal(got.view(np.int32), base.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [7, 5, 9])
def test_reuse_takes_every_source_the_rows_offer(dtype, p):
    """The reuse rule on the paths' ROIs and on degenerate ones: the
    model's values through it are the plain version's bits, and the rows
    take a new tap row, the row before's lo and its hi for the top, and a
    new one, the row before's hi and their own top for the bot."""
    rng = np.random.RandomState(p)
    h, w, c = 11, 15, 64
    feat = torch.tensor(rng.standard_normal((2, h, w, c)) * 4, dtype=dtype)
    rois = np.concatenate([path_rois(rng, 2, 16, h, w), degenerate_rois(rng, 2, 24, h, w)], 1)
    got, writes = kernel_model(feat.float().numpy(), rois, p, 16 // feat.element_size())
    assert (writes == 1).all()
    assert _bits_differing(torch.from_numpy(got).to(dtype),
                           roi_align_cuda.roi_align(feat, torch.from_numpy(rois), p)) == 0
    seen = set()
    for x1, y1, x2, y2 in rois.reshape(-1, 4):
        lo, hi, _ = zip(*(taps(i, y1, y2 - y1, p, h) for i in range(p)))
        seen.update(reuse_sources(lo, hi))
    assert {t for t, _ in seen} == {0, 1, 2} and {m for _, m in seen} == {0, 2, 3}


def test_forward_loads_counts_the_rules_loads():
    """roi_align_taps.forward_loads (what the bench script reports) counts
    the loads reuse_sources leaves: two a new tap row, on the paths' ROIs
    and degenerate ones; 4 where every crop is 14 rows or more."""
    rng = np.random.RandomState(6)
    h, w = MAP_HW
    rois = np.concatenate([path_rois(rng, 2, 30, h, w), degenerate_rois(rng, 2, 30, h, w)], 1)
    loads = []
    for x1, y1, x2, y2 in rois.reshape(-1, 4):
        lo, hi, _ = zip(*(taps(i, y1, y2 - y1, 7, h) for i in range(7)))
        loads += [2 * ((t == 0) + (m == 0)) for t, m in reuse_sources(lo, hi)]
    assert forward_loads(torch.from_numpy(rois), h, 7) == pytest.approx(np.mean(loads))
    tall = np.array([[[0, 0, 20, 14], [3, 2, 9, 30]]], F32)
    assert forward_loads(torch.from_numpy(tall), h, 7) == 4.0


def test_model_matches_the_jax_kernel():
    """f32, against faster_rcnn_tpu's roi_align_pallas (interpret mode),
    whose tap-weight matmuls sum in another order: within 1e-5 of
    max|ref|."""
    import jax.numpy as jnp

    from faster_rcnn_tpu.ops.roi_align_pallas import roi_align_pallas

    rng = np.random.RandomState(4)
    h, w, c = 12, 20, 32
    feat = rng.standard_normal((2, h, w, c)).astype(F32)
    rois = path_rois(rng, 2, 10, h, w)
    got, _ = kernel_model(feat, rois, 7, 4)
    for i in range(2):
        want = np.asarray(roi_align_pallas(jnp.asarray(feat[i]), jnp.asarray(rois[i]), 7, True))
        assert np.abs(got[i] - want).max() <= 1e-5 * np.abs(want).max()
