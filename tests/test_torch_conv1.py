"""The K2 stem-conv kernel's bf16 entry (faster_rcnn_tpu_torch/csrc/conv1.cu,
``conv1_mma_kernel``) as a numpy model, against the port's plain version
(``conv1_cuda.conv1_plain``) and the Pallas kernel in interpret mode, on the
CPU.

The kernel runs only on a card; this model repeats its index arithmetic so
that it is checked here: the weights packed as Wt[n][24*dy + kk] with zeros
at kk >= 21 (dx = 7); the input rows staged as 32-bit words in a ring of 16
slots, zero outside the image; each lane's A, B and C fragment elements of
mma.sync m16n8k16 and m16n8k8, put together into matrices by the PTX
layouts; the XOR-swizzled output buffer and the 16-byte stores. The shared
memory banks of every access are checked too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_tpu.ops.conv1_pallas import conv1_pallas, conv1_pallas_v2
from faster_rcnn_tpu_torch.ops import conv1_cuda

# the kernel's constants (csrc/conv1.cu)
KS, CIN, COUT = 7, 3, 64
KSEG = 24                      # taps (dx, c) per input row, 21 rounded up
KWORDS = KS * KSEG // 2        # 84 bf16 pairs per weight column
KBLOCKS = KS * KSEG // 8       # 21 blocks of 8 in K
TILE, TX, TY = 16, 128, 16
WARPS = 8
SLOTS = 16
ROW_WORDS = 3 * TX + 12
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32: __floats2bfloat162_rn."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def pack_weights(w: np.ndarray) -> np.ndarray:
    """(7, 7, 3, 64) HWIO -> Wt (64, 84, 2): word kw of column n holds k = 2kw
    and 2kw + 1, k = 24*dy + kk, from w[(21*dy + kk)*64 + n]; 0 at kk >= 21."""
    flat = w.reshape(-1)
    wt = np.zeros((COUT, KWORDS, 2), np.float32)
    for i in range(COUT * KWORDS):            # the kernel's loop, one word per i
        n, kw = i & (COUT - 1), i >> 6
        dy, kk = kw // (KSEG // 2), 2 * (kw % (KSEG // 2))
        for half in range(2):
            if kk + half < KS * CIN:
                wt[n, kw, half] = flat[(KS * CIN * dy + kk + half) * COUT + n]
    return wt


def stage_row(x: np.ndarray, b: int, iy: int, x0: int) -> np.ndarray:
    """One ring slot: (ROW_WORDS, 2), word j holding row elements
    6*x0 - 6 + 2j and +1, zero where the pair lies outside the image."""
    h, w = x.shape[1], x.shape[2]
    row_elems = 3 * w
    e = 6 * x0 - 6 + 2 * np.arange(ROW_WORDS)
    assert e[0] % 2 == 0 and row_elems % 2 == 0    # no pair straddles the image's edge
    slot = np.zeros((ROW_WORDS, 2), np.float32)
    if 0 <= iy < h:
        flat = x[b, iy].reshape(-1)
        ok = (e >= 0) & (e < row_elems)
        slot[ok, 0] = flat[e[ok]]
        slot[ok, 1] = flat[e[ok] + 1]
    return slot


def b_frags(wt: np.ndarray, nh: int) -> np.ndarray:
    """(4, 21, 32, 2): per n-tile j and K block m (k = 8m .. 8m+7), each
    lane's B register, read from Wt[32*nh + 8j + g][4m + t]."""
    out = np.empty((4, KBLOCKS, 32, 2), np.float32)
    for j in range(4):
        for m in range(KBLOCKS):
            out[j, m] = wt[32 * nh + 8 * j + G, 4 * m + T]
    return out


def a_words(px: int, m: int) -> np.ndarray:
    """(32, 2): each lane's words of K block m in the slot of tap row m // 3,
    for tile rows g and g + 8."""
    base = 3 * (px + G) + T + 4 * (m % 3)
    return np.stack([base, base + 24], 1)


K_MASK = np.array([[1, 1], [1, 1], [1, 0], [0, 0]], np.float32)  # by t: kk 21..23 -> 0


def a_block(slot: np.ndarray, px: int, m: int) -> np.ndarray:
    """(32, 2, 2): each lane's A registers of K block m (rows g, g + 8),
    with kk >= 21 zeroed in the blocks m % 3 == 2."""
    regs = slot[a_words(px, m)]
    return regs * K_MASK[T][:, None, :] if m % 3 == 2 else regs


def _layout(rows, cols):
    """Flat indices into a (rows x cols) matrix of an (32, regs, 2) fragment:
    lane (g, t) register r half h -> row g (+8 for odd r in A and C), column
    2t + h (+8 for r >= 2 in A)."""
    return np.stack([((G + 8 * (r & 1)) * cols + 2 * T + 8 * (r >> 1) + h)
                     for r in range(rows * cols // 64) for h in range(2)], 1)


# the PTX ISA's fragment layouts of mma.m16n8k16 / m16n8k8 (.bf16, f32 accumulators):
# A a0,a1: row g, k 2t..2t+1; a2,a3: row g+8; a4..a7: the same at k + 8.
# B b0,b1: k 2t..2t+1, column g; b2,b3: k + 8.  C c0,c1: row g, columns 2t..2t+1; c2,c3: row g+8
A16 = _layout(16, 16).reshape(32, 4, 2)
A8 = _layout(16, 8).reshape(32, 2, 2)
C_IDX = _layout(16, 8).reshape(32, 4)
B16 = ((2 * T[:, None, None] + 8 * np.arange(2)[None, :, None] + np.arange(2)) * 8
       + G[:, None, None])                                   # (32, 2, 2) into (16, 8)
B8 = B16[:, 0]                                               # (32, 2) into (8, 8)


def _mma(d, a, b, a_idx, b_idx, k):
    """D = A B + C in f32, the fragments put together by the layouts and D
    handed back to the lanes."""
    A = np.empty(16 * k, np.float32)
    A[a_idx] = a
    B = np.empty(k * 8, np.float32)
    B[b_idx] = b
    C = np.empty(16 * 8, np.float32)
    C[C_IDX] = d
    return (C.reshape(16, 8) + A.reshape(16, k) @ B.reshape(k, 8)).reshape(-1)[C_IDX]


def mma_k16(d, a, b):
    """mma.sync.m16n8k16.row.col: d (32, 4), a (32, 4, 2), b (32, 2, 2)."""
    return _mma(d, a, b, A16, B16, 16)


def mma_k8(d, a, b):
    """mma.sync.m16n8k8.row.col: d (32, 4), a (32, 2, 2), b (32, 2)."""
    return _mma(d, a, b, A8, B8, 8)


def store_tile(out, written, acc, b, oy, ox0, nh, ho, wo):
    """The epilogue: each lane's C pairs into the warp's buffer (16 pixels x
    16 words, chunk j of pixel p at j ^ ((p >> 1) & 3)), then two 16-byte
    reads per lane to 16-byte stores at pixel (lane >> 2) + 8i, chunk lane & 3."""
    buf = np.full((TILE, 16, 2), np.nan, np.float32)
    swz = (G >> 1) & 3
    for j in range(4):
        buf[G, 4 * (j ^ swz) + T] = acc[j][:, 0:2]
        buf[G + 8, 4 * (j ^ swz) + T] = acc[j][:, 2:4]
    flat = out.reshape(-1)
    for i in range(2):
        p, c = (LANE >> 2) + 8 * i, LANE & 3
        words = 4 * (c ^ ((p >> 1) & 3))[:, None] + np.arange(4)
        ox = ox0 + p
        ok = ox < wo
        at = (((b * ho + oy) * wo + ox) * COUT + 32 * nh + 8 * c)[ok, None] + np.arange(8)
        flat[at] = buf[p[:, None], words][ok].reshape(-1, 8)
        written[at] += 1


def tile_acc(ring, held, oy, px, bf):
    """One warp's tile of output row oy: 10 m16n8k16 steps over K blocks
    (2s, 2s + 1) and one m16n8k8 step over block 20; per n-tile j the lanes'
    C registers, (4, 32, 4)."""
    def blk(m):
        slot = (2 * oy + m // 3) & (SLOTS - 1)
        assert held[slot] == 2 * oy - 2 + m // 3  # the ring kept the row
        return a_block(ring[slot], px, m)

    acc = np.zeros((4, 32, 4), np.float32)
    for s in range(KBLOCKS // 2):
        a16 = np.concatenate([blk(2 * s), blk(2 * s + 1)], 1)  # a0, a1 | a2, a3
        for j in range(4):
            acc[j] = mma_k16(acc[j], a16, bf[j, 2 * s:2 * s + 2].transpose(1, 0, 2))
    a8 = blk(KBLOCKS - 1)
    for j in range(4):
        acc[j] = mma_k8(acc[j], a8, bf[j, KBLOCKS - 1])
    return acc


def model_conv1(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) x (7, 7, 3, 64) -> (B, H/2, W/2, 64) in f32, block by
    block, warp by warp, lane by lane, as the kernel computes it. The kernel
    rounds each value to bf16 once, in the epilogue: ``bf16_round`` of this."""
    bsz, h, wd, _ = x.shape
    ho, wo = h // 2, wd // 2
    out = np.full((bsz, ho, wo, COUT), np.nan, np.float32)
    written = np.zeros(out.size, np.int64)
    wt = pack_weights(w)
    bfr = [b_frags(wt, nh) for nh in range(2)]
    for b in range(bsz):
        for y0 in range(0, ho, TY):
            for x0 in range(0, wo, TX):
                ny = min(TY, ho - y0)
                ring = np.full((SLOTS, ROW_WORDS, 2), np.nan, np.float32)
                held = np.full(SLOTS, -99)

                def stage(iy):
                    ring[(iy + 2) & (SLOTS - 1)] = stage_row(x, b, iy, x0)
                    held[(iy + 2) & (SLOTS - 1)] = iy

                for dy in range(KS):
                    stage(2 * y0 - 2 + dy)
                for r in range(ny):
                    oy = y0 + r
                    if r + 1 < ny:
                        stage(2 * oy + 5)
                        stage(2 * oy + 6)
                    for warp in range(WARPS):
                        nh = warp & 1
                        for q in range(2):
                            px = TILE * ((warp >> 1) + 4 * q)
                            if x0 + px >= wo:
                                break
                            acc = tile_acc(ring, held, oy, px, bfr[nh])
                            store_tile(out, written, acc, b, oy, x0 + px, nh, ho, wo)
    np.testing.assert_array_equal(written, 1)  # every output element stored once
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _inputs(rng, shape, integer):
    if integer:  # every product and sum exact in f32
        return (rng.randint(-8, 9, shape).astype(np.float32),
                rng.randint(-4, 5, (7, 7, 3, 64)).astype(np.float32))
    x = bf16_round(rng.standard_normal(shape).astype(np.float32))
    return x, bf16_round((rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32))


SHAPES = [(2, 2, 74), (2, 16, 74), (1, 40, 300)]  # Wo 37, 37, 150: ragged tiles;
# H = 2 reads padding in every tap row but 2-4; 40 x 300 takes 2 x 2 blocks


def _pallas(x, k):
    """The Pallas kernel in interpret mode: v2, whose blocks need H/2 a
    multiple of 4 (the JAX package's canvases are multiples of 32), else v1,
    the same function at any even H."""
    fn = conv1_pallas_v2 if (x.shape[1] // 2) % 4 == 0 else conv1_pallas
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(k), True))


@pytest.mark.parametrize("b,h,w", SHAPES)
def test_model_bit_for_bit_on_integers(b, h, w):
    """Integer inputs in [-8, 8] and weights in [-4, 4], where every sum is
    exact in f32: the model equals the plain version and the Pallas kernel
    in f32, and rounded to bf16 the plain version in bf16, bit for bit."""
    rng = np.random.RandomState(b * 1000 + h * 10 + w)
    x, k = _inputs(rng, (b, h, w, 3), integer=True)
    got = model_conv1(x, k)
    np.testing.assert_array_equal(got, conv1_cuda.conv1_plain(torch.tensor(x),
                                                              torch.tensor(k)).numpy())
    np.testing.assert_array_equal(got, _pallas(x, k))
    plain16 = conv1_cuda.conv1_plain(torch.tensor(x, dtype=torch.bfloat16),
                                     torch.tensor(k, dtype=torch.bfloat16))
    np.testing.assert_array_equal(bf16_round(got), plain16.float().numpy())


@pytest.mark.parametrize("b,h,w", SHAPES[:2])
def test_model_matches_plain_and_pallas(b, h, w):
    """Normal bf16-valued inputs: the model in f32 within 1e-4 of max|ref| of
    the plain version and of the Pallas kernel (the sums run in other
    orders)."""
    rng = np.random.RandomState(7 + h)
    x, k = _inputs(rng, (b, h, w, 3), integer=False)
    got = model_conv1(x, k)
    for want in (conv1_cuda.conv1_plain(torch.tensor(x), torch.tensor(k)).numpy(),
                 _pallas(x, k)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_fragment_layouts_cover_each_element_once():
    """Every element of A (16 x 16, 16 x 8), B (16 x 8, 8 x 8) and C
    (16 x 8) belongs to exactly one (lane, register, half)."""
    for idx, size in ((A16, 256), (A8, 128), (B16, 128), (B8, 64), (C_IDX, 128)):
        np.testing.assert_array_equal(np.sort(idx.reshape(-1)), np.arange(size))


def test_packed_weights_are_7x24x64_with_zero_dx7():
    """Wt[n][24*dy + 3*dx + c] = w[dy, dx, c, n]; the three taps of dx = 7
    are zero."""
    w = np.random.RandomState(0).standard_normal((7, 7, 3, 64)).astype(np.float32)
    wt = pack_weights(w).reshape(COUT, KS, KSEG)
    np.testing.assert_array_equal(wt[:, :, :21], w.reshape(7, 21, 64).transpose(2, 0, 1))
    np.testing.assert_array_equal(wt[:, :, 21:], 0)


def _rows(d):
    """Each lane's C registers (32, 4) back into the (16, 8) matrix."""
    c = np.empty(128, np.float32)
    c[C_IDX] = d
    return c.reshape(16, 8)


def test_fragments_are_the_im2col_patches():
    """Each K block's A fragments of a tile, placed by the m16n8k8 layout
    (rows g and g + 8, k 2t, 2t + 1: the same registers as either half of a
    k16 step), are the 16 x 8 patch matrix of the SAME-padded input with
    zeros at kk >= 21, and its B fragments the 8 x 8 weight slices (zeros at
    kk >= 21): A I and I B through the mma model give them back."""
    rng = np.random.RandomState(1)
    x = rng.standard_normal((1, 6, 300, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 64)).astype(np.float32)
    xpad = np.pad(x, ((0, 0), (2, 3), (2, 3 + 2 * TX), (0, 0)))
    taps = np.zeros((KS, KSEG, 64), np.float32)
    taps[:, :21] = w.reshape(7, 21, 64)
    taps = taps.reshape(KS * KSEG, 64)
    bfr = [b_frags(pack_weights(w), nh) for nh in range(2)]
    zero = np.zeros((32, 4), np.float32)
    eye = np.eye(16, dtype=np.float32)
    for x0, px, oy in [(0, 0, 0), (128, 16, 2), (128, 0, 1)]:
        for m in range(KBLOCKS):
            dy, kk = m // 3, 8 * (m % 3)
            patch = np.zeros((16, KSEG), np.float32)
            for row in range(16):
                ox = x0 + px + row
                patch[row, :21] = xpad[0, 2 * oy + dy, 2 * ox:2 * ox + 7].reshape(-1)
            a = a_block(stage_row(x, 0, 2 * oy - 2 + dy, x0), px, m)
            got = mma_k8(zero, a, eye[:8, :8].reshape(-1)[B8])
            np.testing.assert_array_equal(_rows(got), patch[:, kk:kk + 8])
            for nh in (0, 1):
                for j in range(4):
                    got = mma_k8(zero, eye[:, :8].reshape(-1)[A8], bfr[nh][j, m])
                    c = 32 * nh + 8 * j
                    np.testing.assert_array_equal(_rows(got)[:8], taps[8 * m:8 * m + 8, c:c + 8])


def _banks_ok(words):
    """One warp's 32-bit shared accesses: no two lanes on one bank unless
    they read the same word."""
    by_bank = {}
    for wd in np.asarray(words).reshape(-1):
        by_bank.setdefault(int(wd) % 32, set()).add(int(wd))
    return all(len(v) == 1 for v in by_bank.values())


def test_shared_memory_accesses_have_no_bank_conflicts():
    """A loads (word 3(px+g) + t + 4(m % 3), +24), B loads (84 words a column),
    the epilogue's 32-bit writes and its 16-byte reads (in quarter warps of
    8 lanes, each covering 4 banks)."""
    for px in range(0, TX, TILE):
        for m in range(KBLOCKS):
            for col in a_words(px, m).T:
                assert _banks_ok(col)
    for nh in (0, 1):
        for j in range(4):
            for m in range(KBLOCKS):
                assert _banks_ok((32 * nh + 8 * j + G) * KWORDS + 4 * m + T)
    swz = (G >> 1) & 3
    for j in range(4):
        assert _banks_ok(16 * G + 4 * (j ^ swz) + T)
        assert _banks_ok(16 * (G + 8) + 4 * (j ^ swz) + T)
    for i in range(2):
        p, c = (LANE >> 2) + 8 * i, LANE & 3
        first = 16 * p + 4 * (c ^ ((p >> 1) & 3))
        for quarter in range(4):
            lanes = first[8 * quarter:8 * quarter + 8]
            assert _banks_ok((lanes[:, None] + np.arange(4)).reshape(-1))


def test_staged_row_pads_with_zeros():
    """Rows above and below the image are zero; at x0 = 0 the two columns
    before the image (SAME padding) are zero, and so is everything past the
    image's right edge."""
    x = np.arange(1, 1 + 2 * 4 * 10 * 3, dtype=np.float32).reshape(2, 4, 10, 3)
    for iy in (-2, -1, 4, 5, 6):
        np.testing.assert_array_equal(stage_row(x, 1, iy, 0), 0)
    row = stage_row(x, 1, 2, 0).reshape(-1)
    np.testing.assert_array_equal(row[:6], 0)
    np.testing.assert_array_equal(row[6:36], x[1, 2].reshape(-1))
    np.testing.assert_array_equal(row[36:], 0)
