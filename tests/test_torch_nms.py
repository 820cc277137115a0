"""The K3 NMS kernel's algorithm (faster_rcnn_tpu_torch/csrc/nms.cu) as a
numpy model, against the port's plain version (ops/nms.py) and the Pallas
kernel in interpret mode, on the CPU.

The kernel runs only on a card; this model repeats its steps so that the
algorithm is checked here: one cluster of C blocks per image; the survivors
so far as boxes spread round-robin over the blocks; each block's sweep of
the tile against its share, ORed into the leader's mask; the tile's bit
matrix (IoU > thresh for j < k) as column words, cut into 32 x 32 blocks
that the cluster's warps share, in a leader's buffer that holds stale words
from earlier phases below the diagonal; the leader's walk one word of 32
candidates at a time, each word's survivors the fixpoint of a ballot; the
`enough` stop and the tail that keeps its valid value. The IoU is the
kernel's: f32 throughout, fmaxf/fminf as numpy's fmax/fmin (both drop a NaN
operand), and no divide where !(inter > 0) when thresh >= 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_tpu.ops.nms_pallas import nms_keep_mask_pallas
from faster_rcnn_tpu_torch.ops import nms, nms_cuda
from tests.test_torch_gpu import nms_case

FAR = np.float32(-1e8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def iou_parts(a, b):
    """(M, 4) x (K, 4) f32 -> the kernel's overlap pre-test (for
    thresh >= 0), inter and quotient, (M, K) each, in its operation
    order."""
    f1 = np.float32(1)
    with np.errstate(all="ignore"):
        x1 = np.fmax(a[:, None, 0], b[None, :, 0])
        y1 = np.fmax(a[:, None, 1], b[None, :, 1])
        x2 = np.fmin(a[:, None, 2], b[None, :, 2])
        y2 = np.fmin(a[:, None, 3], b[None, :, 3])
        maybe = (x2 - x1 > np.float32(-1)) & (y2 - y1 > np.float32(-1))
        iw = np.fmax(np.float32(0), x2 - x1 + f1)
        ih = np.fmax(np.float32(0), y2 - y1 + f1)
        inter = iw * ih
        area_a = (a[:, 2] - a[:, 0] + f1) * (a[:, 3] - a[:, 1] + f1)
        area_b = (b[:, 2] - b[:, 0] + f1) * (b[:, 3] - b[:, 1] + f1)
        return maybe, inter, inter / (area_a[:, None] + area_b[None, :] - inter)


def iou_gt(a, b, thresh):
    """The kernel's answer to IoU > thresh: for thresh >= 0 only the pairs
    that pass the pre-test take the divide, the others are false."""
    maybe, _, q = iou_parts(a, b)
    with np.errstate(invalid="ignore"):
        gt = q > np.float32(thresh)
    return gt & maybe if thresh >= 0 else gt


def pack(bits):
    """(32 W,) bool -> (W,) uint32: bit t of word w is element 32 w + t."""
    return (bits.reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        1).astype(np.uint32)


def block_of(u, w_):
    """The kernel's decode of bit-matrix block u: row-major over a <= w."""
    a, x = 0, u
    while x >= w_ - a:
        x -= w_ - a
        a += 1
    return a, a + x


def matrix_blocks(t, c, r):
    """The (a, w) blocks block r of a c-block cluster computes: block u on
    block u % c of the cluster."""
    w_ = t // 32
    return [block_of(u, w_) for u in range(w_ * (w_ + 1) // 2) if u % c == r]


def capacity(n, t, enough, c):
    """Survivor boxes a block holds at most, in runs of 32 (csrc/nms.cu
    capacity)."""
    most = enough - 1 + t if enough > 0 and enough - 1 + t < n else n
    return -(-(-(-most // c)) // 32) * 32


def model_keep(boxes, valid, thresh, t, enough, c, seed=0):
    """One image's keep mask as a cluster of c blocks computes it."""
    n, w_ = boxes.shape[0], t // 32
    parked = np.where(valid[:, None], boxes, FAR).astype(np.float32)
    shares = [[] for _ in range(c)]
    keep = np.zeros(n, bool)
    # the leader's column words, with stale words the walk must never read
    col = np.random.RandomState(seed).randint(0, 2 ** 32, (w_, t), dtype=np.uint64).astype(
        np.uint32)
    above = np.arange(t)[:, None] < np.arange(t)[None, :]  # j < k
    total, off = 0, 0
    for off in range(0, n + 1, t):
        if off == n or (enough > 0 and total >= enough):
            break
        tb, tv = parked[off:off + t], valid[off:off + t]
        # 1. each block's sweep, ORed into one mask; for thresh >= 0 the
        #    FAR boxes that pad a share to runs of 32 take part
        sup = np.zeros(t, bool)
        for r in range(c):
            assert len(shares[r]) == (total - r + c - 1) // c
            pad = -len(shares[r]) % 32 if thresh >= 0 else 0
            assert len(shares[r]) + pad <= capacity(n, t, enough, c)
            if shares[r]:
                share = np.array(shares[r] + [[FAR] * 4] * pad, np.float32)
                sup |= iou_gt(share, tb, thresh).any(0) & tv
        # 2. each block's 32 x 32 blocks of column words, valid columns only
        gt = iou_gt(tb, tb, thresh) & above
        for r in range(c):
            for a, w in matrix_blocks(t, c, r):
                ks = np.arange(32 * w, 32 * w + 32)
                col[a, ks] = pack((gt[32 * a:32 * a + 32, ks] & tv[ks]).T.reshape(-1))
        # 3. the walk: a word's live candidates, then the ballot fixpoint
        kept_words, new = [], []
        for w in range(w_):
            ks = np.arange(32 * w, 32 * w + 32)
            hit = np.zeros(32, np.uint32)
            for v in range(w):
                hit |= col[v, ks] & np.uint32(kept_words[v])
            live = tv[ks] & ~sup[ks] & (hit == 0)
            kept, prev = int(pack(live)[0]), None
            while kept != prev:
                prev = kept
                kept = int(pack(live & ((col[w, ks] & np.uint32(kept)) == 0))[0])
            kept_words.append(kept)
            lanes = [(kept >> b) & 1 for b in range(32)]
            keep[off + 32 * w:off + 32 * w + 32] = lanes
            new += [32 * w + b for b in range(32) if lanes[b]]
        # 4. survivor g = total + i to block g % c, at g // c
        for i, idx in enumerate(new):
            g = total + i
            assert len(shares[g % c]) == g // c
            shares[g % c].append(tb[idx])
        total += len(new)
    keep[off:] = valid[off:]
    return keep


def _plain(boxes, valid, thresh, tile, enough):
    return nms.nms_sorted_mask_blocked(torch.tensor(boxes), torch.tensor(valid), thresh,
                                       tile=tile, enough=enough).numpy()


@functools.lru_cache(maxsize=None)
def _references(tile, enough):
    """(boxes, valid, plain mask, Pallas mask) of three 1024-box images of
    clustered boxes, 1000 valid, at IoU 0.5; Pallas in interpret mode."""
    boxes, valid = nms_case("clustered", 3, 1024, 1000, seed=tile + enough)
    pallas = np.stack([np.asarray(nms_keep_mask_pallas(
        jnp.asarray(bx), jnp.asarray(v), 0.5, tile=tile, enough=enough, interpret=True))
        for bx, v in zip(boxes, valid)])
    return boxes, valid, _plain(boxes, valid, 0.5, tile, enough), pallas


@pytest.mark.parametrize("enough", [0, 30, 300])
@pytest.mark.parametrize("tile", [32, 128, 512])
@pytest.mark.parametrize("c", [1, 2, 8])
def test_model_matches_plain_and_pallas(c, tile, enough):
    """Bit for bit, the tail after the stopping tile included."""
    boxes, valid, plain, pallas = _references(tile, enough)
    np.testing.assert_array_equal(plain, pallas)
    got = np.stack([model_keep(bx, v, 0.5, tile, enough, c, seed=i)
                    for i, (bx, v) in enumerate(zip(boxes, valid))])
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("kind,thresh,tile,enough", [
    ("identical", 0.7, 128, 300),
    ("disjoint", 0.7, 128, 0),
    ("nan", 0.7, 128, 0),
    ("clustered", 0.0, 128, 0),
    ("class_offset", 0.5, 128, 300),
    ("clustered", 0.7, 1024, 0),
])
def test_model_matches_plain_on_hard_cases(kind, thresh, tile, enough):
    """The GPU test's hard cases (tests/test_torch_gpu.py nms_case) at 2048
    boxes on a cluster of 8: one survivor in all, every box a survivor (the
    largest share a block holds), NaN coordinates, thresh 0, class
    offsets, a tile of 1024."""
    boxes, valid = nms_case(kind, 2, 2048, 1900)
    got = np.stack([model_keep(bx, v, thresh, tile, enough, 8) for bx, v in zip(boxes, valid)])
    np.testing.assert_array_equal(got, _plain(boxes, valid, thresh, tile, enough))


def _iou_boxes():
    """Random, degenerate (zero and negative width, a point), FAR-parked,
    NaN in each coordinate, +-inf and huge boxes, and boxes 0.5, 0.9999, 1,
    1.0001 and 2 px right of [10, 10, 20, 20], about the pre-test's edge."""
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 60, (200, 2))
    wh = rng.uniform(-3, 40, (200, 2))
    rand = np.concatenate([x, x + wh], 1)
    special = [[FAR] * 4, [10, 10, 10, 10], [10, 10, 9, 30], [10, 10, 8, 8], [0, 0, 1e30, 1e30],
               [-np.inf, 0, np.inf, 5], [np.inf, 0, np.inf, 5], [0, 0, 1e20, 3],
               [10, 10, 20, 20]] + [[20 + dx, 10, 30, 20] for dx in (0.5, 0.9999, 1, 1.0001, 2)]
    for i in range(4):
        row = [5.0, 5.0, 30.0, 30.0]
        row[i] = np.nan
        special.append(row)
    return np.concatenate([rand, np.array(special)]).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_iou_divide_skip_changes_no_bit(thresh):
    """For thresh >= 0 the pairs the pre-test drops have !(inter > 0), and
    there the quotient is 0, -0 or NaN, so the skipped divide could not have
    said IoU > thresh; the kernel's answer (fmaxf, which drops NaN) equals
    the plain version's IoU > thresh (torch.maximum, which keeps it) on
    every pair."""
    b = _iou_boxes()
    maybe, inter, q = iou_parts(b, b)
    assert (~maybe).any() and maybe.any()
    assert not (~maybe & (inter > 0)).any()
    with np.errstate(invalid="ignore"):
        assert not (q[~(inter > 0)] > np.float32(thresh)).any()
    plain = nms._pairwise_iou_p1(torch.tensor(b), torch.tensor(b)) > thresh
    np.testing.assert_array_equal(iou_gt(b, b, thresh), plain.numpy())


def test_iou_divide_skip_needs_a_nonnegative_thresh():
    """Below 0 a disjoint pair's quotient 0 is > thresh: the kernel then
    takes the divide for every pair."""
    b = _iou_boxes()
    maybe, _, q = iou_parts(b, b)
    with np.errstate(invalid="ignore"):
        assert ((q > np.float32(-0.5)) & ~maybe).any()
        assert (iou_gt(b, b, -0.5) == (q > np.float32(-0.5))).all()


@pytest.mark.parametrize("tile", [32, 96, 128, 512, 1024])
@pytest.mark.parametrize("c", [1, 2, 3, 6, 8])
def test_matrix_blocks_cover_the_upper_triangle_once(c, tile):
    """The kernel's decode enumerates the blocks a <= w row-major, and the
    cluster's blocks compute each once, each within one of the others'
    count."""
    w_ = tile // 32
    assert [block_of(u, w_) for u in range(w_ * (w_ + 1) // 2)] == \
        [(a, w) for a in range(w_) for w in range(a, w_)]
    parts = [matrix_blocks(tile, c, r) for r in range(c)]
    flat = [u for us in parts for u in us]
    assert sorted(flat) == [(a, w) for a in range(w_) for w in range(a, w_)]
    sizes = [len(us) for us in parts]
    assert max(sizes) - min(sizes) <= 1


# clusters of c blocks of 1024 threads an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters; NVIDIA H100 80GB HBM3, 700 W): its GPCs
# hold two clusters of 8, or of 7, but one of them holds only one
H100_ACTIVE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("b,tile,want", [
    (1, 512, 8), (2, 512, 8), (15, 512, 8), (16, 512, 6), (20, 512, 5), (33, 512, 3),
    (16, 128, 4), (16, 32, 1), (133, 512, 1),
])
def test_cluster_size(b, tile, want):
    """The largest cluster whose b copies run in one wave, at most tile //
    32 blocks; at B = 16 a cluster of 8 would leave one image for a second
    wave."""
    assert nms_cuda.cluster_size(b, tile, H100_ACTIVE.get) == want
