"""The K4 top-k kernel's algorithm (faster_rcnn_tpu_torch/csrc/topk.cu), as
a numpy model, against jax.lax.top_k, the Pallas kernel in interpret mode
and the port's plain version (ops/sort.py), on the CPU.

The kernel runs only on a card; this model repeats its steps so that the
algorithm is checked here: S slices per row, a radix select of the k-th key
in 11-, 11- and 10-bit digits from per-slice histograms, per-slice counts and
tie offsets that keep the first ties in index order, 1024-pair chunks sorted
on their own and merged by ranks. The big shapes run in numpy; the Pallas
interpreter only at n <= 5000.

The order is lax.top_k's, the IEEE total order: +NaN first, +0.0 above
-0.0, a NaN with its sign bit set last. The Pallas kernel does not order
NaN, so it is held only to the cases without NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import topk_adversarial
from faster_rcnn_tpu.ops.sort_pallas import topk_sorted_pallas
from faster_rcnn_tpu_torch.ops import sort, sort_cuda

DIGITS = ((21, 11), (10, 11), (0, 10))  # (shift, bits) of the three select passes
CHUNK = 1024
H100_SMS = 132


def desc_key(x: np.ndarray) -> np.ndarray:
    """The kernel's key: smaller key = earlier in the output, descending in
    the IEEE total order."""
    u = x.view(np.uint32)
    return np.where(u & 0x80000000, u, ~u & 0x7FFFFFFF).astype(np.uint32)


def _slices(n, s):
    w = -(-n // s)
    return [np.arange(j * w, min(n, (j + 1) * w)) for j in range(s)]


def model_select(keys, k, s):
    """The k-th smallest key and how many of its ties belong to the top k:
    each pass adds the slices' histograms of the keys that match the prefix
    so far, and finds the bin of the krem-th key."""
    prefix, krem = 0, k
    for shift, bits in DIGITS:
        top = shift + bits
        match = 0 if top == 32 else (0xFFFFFFFF << top) & 0xFFFFFFFF
        hist = np.zeros(2048, np.int64)
        for idx in _slices(keys.shape[0], s):
            part = keys[idx]
            part = part[(part & np.uint32(match)) == np.uint32(prefix)]
            hist += np.bincount((part >> np.uint32(shift)) & np.uint32((1 << bits) - 1),
                                minlength=2048)
        cum = np.cumsum(hist)
        d = int(np.searchsorted(cum, krem))  # the first bin whose sum reaches krem
        krem -= int(cum[d - 1]) if d else 0
        prefix |= d << shift
    return np.uint32(prefix), krem


def model_filter(keys, k, s, kth, krem):
    """The k kept (key << 32 | index) pairs: per slice, its keys below the
    k-th key at the exclusive sum of the earlier slices' counts, and its ties
    whose rank in index order over the row is below krem after them."""
    slices = _slices(keys.shape[0], s)
    n_lt = np.array([(keys[i] < kth).sum() for i in slices])
    n_eq = np.array([(keys[i] == kth).sum() for i in slices])
    lt_off = np.cumsum(n_lt) - n_lt
    eq_off = np.cumsum(n_eq) - n_eq
    assert n_lt.sum() == k - krem
    kept = np.full(k, ~np.uint64(0))
    for idx, lo, eo in zip(slices, lt_off, eq_off):
        pairs = (keys[idx].astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint64)
        lt, eq = keys[idx] < kth, keys[idx] == kth
        kept[lo + np.arange(lt.sum())] = pairs[lt]
        rank = eo + np.arange(eq.sum())
        kept[k - krem + rank[rank < krem]] = pairs[eq][rank < krem]
    assert not np.any(kept == ~np.uint64(0))
    return kept


def model_sort_merge(kept):
    """Each 1024 pairs sorted on their own, then every pair placed at its
    place in its chunk plus the pairs below it in each other chunk."""
    chunks = [np.sort(kept[c:c + CHUNK]) for c in range(0, kept.shape[0], CHUNK)]
    out = np.empty_like(kept)
    slots = []
    for c, mine in enumerate(chunks):
        slot = np.arange(mine.shape[0])
        for o, other in enumerate(chunks):
            if o != c:
                slot = slot + np.searchsorted(other, mine, side="left")
        out[slot] = mine
        slots.append(slot)
    np.testing.assert_array_equal(np.sort(np.concatenate(slots)), np.arange(kept.shape[0]))
    return out


def model_topk(x, k, s):
    """(B, N) f32 -> (values, int64 indices), as the kernel computes them."""
    vals = np.empty((x.shape[0], k), np.float32)
    idx = np.empty((x.shape[0], k), np.int64)
    for r in range(x.shape[0]):
        keys = desc_key(x[r])
        kth, krem = model_select(keys, k, s)
        out = model_sort_merge(model_filter(keys, k, s, kth, krem))
        idx[r] = (out & np.uint64(0xFFFFFFFF)).astype(np.int64)
        vals[r] = x[r, idx[r]]
    return vals, idx


def _same_bits(got, want_v, want_i):
    np.testing.assert_array_equal(got[1], np.asarray(want_i))
    np.testing.assert_array_equal(got[0].view(np.uint32), np.asarray(want_v).view(np.uint32))


def _plain(x, k):
    v, i = sort.topk_sorted_plain(torch.tensor(x), k)
    return v.numpy(), i.numpy()


def _lax(x, k):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("k", [128, 256, 6000, 8000])
def test_model_matches_lax_top_k_at_the_path_shapes(k):
    """16 x 64,296 at the paths' k with 17 slices a row (the kernel's choice
    on 132 SMs): masks, plateaus holding the k-th key across every slice
    boundary, signed zeros, an all-NaN row, NaN of both signs, inf and
    -inf."""
    x = topk_adversarial(k, seed=k)
    s = sort_cuda.slices_per_row(16, 64296, H100_SMS)
    assert s == 17
    got = model_topk(x, k, s)
    _same_bits(got, *_lax(x, k))
    _same_bits(got, *_plain(x, k))


PLATEAU_N = 4099
PLATEAU_CASES = [  # (k, slices)
    (300, 4),     # one chunk
    (2100, 3),    # three chunks and the merge; n not a multiple of s
    (1, 7),       # k = 1
    (4099, 5),    # k = n, five chunks
    (1025, 2),    # two chunks, the second of one pair
]


@pytest.fixture(scope="module")
def plateau_rows():
    """(rows, Pallas values, Pallas indices): per case of PLATEAU_CASES a
    -1e30 and a 0.25 plateau row that hold its k-th key across every slice
    boundary, then a 0.5 tie plateau under -1e30 masks and a row with +0.0
    before -0.0 in index order and +inf. The Pallas kernel sorts them whole
    once, in interpret mode (about 5 s)."""
    rng = np.random.RandomState(7)
    n = PLATEAU_N
    rows = []
    for k, _ in PLATEAU_CASES:
        for plateau in (-1e30, 0.25):
            row = np.full(n, plateau, np.float32)
            row[rng.choice(n, k // 2, replace=False)] = rng.uniform(0.5, 1.0, k // 2)
            rows.append(row)
    ties = rng.uniform(size=n).astype(np.float32)
    ties[rng.uniform(size=n) < 0.3] = -1e30
    ties[rng.randint(0, n, n // 10)] = 0.5
    zeros = rng.uniform(size=n).astype(np.float32)
    zeros[:n // 3] = 0.0
    zeros[n // 3:n // 2] = -0.0
    zeros[-5:] = np.inf
    x = np.stack(rows + [ties, zeros])
    pv, pi = jax.vmap(lambda r: topk_sorted_pallas(r, n, interpret=True))(jnp.asarray(x))
    return x, np.asarray(pv), np.asarray(pi)


@pytest.mark.parametrize("case", range(len(PLATEAU_CASES)))
def test_model_matches_pallas_and_lax_on_plateaus(plateau_rows, case):
    """The model against the Pallas kernel, lax.top_k and the plain version
    on the case's two plateau rows and the two shared rows."""
    k, s = PLATEAU_CASES[case]
    rows = [2 * case, 2 * case + 1, -2, -1]
    x = plateau_rows[0][rows]
    got = model_topk(x, k, s)
    _same_bits(got, *_lax(x, k))
    _same_bits(got, *_plain(x, k))
    _same_bits(got, plateau_rows[1][rows, :k], plateau_rows[2][rows, :k])


@pytest.mark.parametrize("case", ["signed_zeros", "nan_both_signs", "all_nan"])
def test_model_matches_lax_top_k_on_signed_zeros_and_nan(rng, case):
    """-0.0 before +0.0 in index order, NaN with either sign, an all-NaN row,
    where a stable torch.sort of the floats on the CPU orders otherwise: the
    model against lax.top_k, the plain version and the port's CPU
    wrapper."""
    n, k, s = 3000, 1500, 3
    x = rng.uniform(-1, 1, size=(2, n)).astype(np.float32)
    if case == "signed_zeros":
        x[:, :1000] = -0.0
        x[:, 1000:2000] = 0.0
    elif case == "nan_both_signs":
        x[:, rng.randint(0, n, 200)] = np.nan
        x[:, rng.randint(0, n, 200)] = -np.nan
    else:
        x[1] = np.nan
    got = model_topk(x, k, s)
    _same_bits(got, *_lax(x, k))
    _same_bits(got, *_plain(x, k))
    v, i = sort_cuda.topk_sorted(torch.tensor(x), k)
    _same_bits(got, v.numpy(), i.numpy())


@pytest.mark.parametrize("b,n,want", [
    (16, 64296, 17), (1, 64296, 62), (4, 2000, 1), (2, 500, 1), (64, 64296, 5),
])
def test_slices_per_row(b, n, want):
    """B * S reaches twice the SM count, no slice under 1024 keys."""
    assert sort_cuda.slices_per_row(b, n, H100_SMS) == want
