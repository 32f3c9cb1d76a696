"""The port's suffix array, LCP and thresholds (colbwt_tpu_torch/ops/
construct.py: K11a, K11b and K12) against the JAX package's
(ops/construct_jax.py) and the host oracle, on the CPU, where their plain
PyTorch versions run; then the build's route without the native library:
both packages' build_pipeline with `native.available` patched to False
must write the same bytes, the port through its device suffix array from
_DEVICE_MIN_N and through the oracle below it; and bench.py's index-build
sequence through the port's ops against the same sequence in JAX.  Every
value is an integer, so every comparison is exact.
"""

import functools
import math
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colbwt_tpu.io.native as JN
import colbwt_tpu.pipeline.build as JB
import colbwt_tpu_torch.io.native as TN
import colbwt_tpu_torch.ops.oracle as TO
import colbwt_tpu_torch.pipeline.build as TB
from colbwt_tpu.models.index import ColPmlIndex as JIndex
from colbwt_tpu.ops import construct_jax as CJ
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops.colsplit_jax import col_split_jax
from colbwt_tpu.pipeline import build_pipeline as jax_build
from colbwt_tpu.utils.config import ColBwtConfig
from colbwt_tpu_torch.models.index import ColPmlIndex as TIndex
from colbwt_tpu_torch.ops import colsplit as TCS
from colbwt_tpu_torch.ops import construct as TC
from colbwt_tpu_torch.pipeline import build_pipeline
from tests.conftest import random_docs
from tests.test_torch_kernels import ARGMIN_CASES, argmin_case

CPU = "cpu"
GOLD = Path(__file__).parent / "goldens"
CFG = dict(min_mum=20, split_rate=10, rev_comp=True, keep_temp=True)
ARTIFACTS = ["fa.bwt.heads", "fa.bwt.len", "fa.thr_pos", "fa.col_mums",
             "lengths", "fa.col_runs", "fa.col_ids", "fa.col_pml"]
# tests/test_construct_jax.py:41, heavy repeats for the lifting
REPETITIVE = [b"ACGT" * 30, b"ACGT" * 30 + b"A", b"ACGTACGT" * 15]


def _ranks(docs):
    return O.concat_collection(docs)[1]


def _collection(seed):
    rng = np.random.default_rng(seed)
    return random_docs(rng, int(rng.integers(1, 6)), lo=20, hi=150)


@pytest.mark.parametrize("k", [1, 2, 5, 64, "n", "n+3"])
def test_doubling_round_matches_jax(rng, k):
    """One round from the base ranks and one from dense ranks, for k below
    n and k >= n (every next rank -1): order, new ranks, largest rank."""
    ranks = _ranks(random_docs(rng, 3, lo=30, hi=90)).astype(np.int32)
    n = ranks.size
    k = {"n": n, "n+3": n + 3}.get(k, k)
    dense = np.asarray(CJ._doubling_round(jnp.asarray(ranks),
                                          jnp.int32(1))[1])
    for rank in (ranks, dense):
        want = CJ._doubling_round(jnp.asarray(rank), jnp.int32(k))
        for fn in (TC.doubling_round_ref,
                   lambda r, k: TC.doubling_round(r, k, int(r.max()))):
            got = fn(torch.from_numpy(rank.copy()), k)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_rounds(ranks, ks=None):
    """(rank, k, order) before each round of suffix_array_jax: `order` is
    the previous round's (the stable argsort of ranks0 before the first).
    With `ks` the rounds run at those k and past the early exit."""
    n = ranks.size
    rank = np.asarray(ranks, dtype=np.int32)
    order = np.argsort(rank, kind="stable").astype(np.int32)
    early = ks is None
    if early:
        ks = [1 << j for j in range(max(1, math.ceil(math.log2(max(n, 2)))))]
    out = []
    for k in ks:
        out.append((rank, k, order))
        o, r, top = CJ._doubling_round(jnp.asarray(rank), jnp.int32(k))
        order, rank = np.asarray(o), np.asarray(r)
        if early and int(top) == n - 1:
            break
    return out


def _jax_next_rank(rank, k):
    """construct_jax.py:62: rank[i + k], -1 where i >= n - k."""
    n = rank.size
    iota = np.arange(n)
    return np.where(iota < n - k, np.roll(rank, -k), -1)


NEXT_RANK_CASES = [0, 1, 2, 3, "repetitive", "one doc", "n=1", "n=2", "n=3",
                   "k>=n"]


def _next_rank_case(case):
    """(ranks0, the k of each round, or None for suffix_array_jax's)."""
    if case in ("n=1", "n=2", "n=3"):
        n = int(case[-1])
        return _ranks([[b"", b"A", b"AC"][n - 1]]), [1, 2, 4, 8]
    if case == "k>=n":
        ranks = _ranks([b"ACGTAC", b"ACG"])
        n = ranks.size
        return ranks, [1, 2, n - 1, n, n + 1, 2 * n]
    docs = {"repetitive": REPETITIVE,
            "one doc": [b"GATTACA" * 9]}.get(case) or _collection(case)
    return _ranks(docs), None


@pytest.mark.parametrize("case", NEXT_RANK_CASES)
def test_next_rank_order_matches_jax_argsort(case):
    """K11a's first radix pass reads the order by (next_rank, index) off
    the previous round's order: next_rank_order_ref equals the stable
    argsort of JAX's next_rank in every round."""
    ranks, ks = _next_rank_case(case)
    rounds = _jax_rounds(ranks, ks)
    assert rounds
    for rank, k, order in rounds:
        want = np.argsort(_jax_next_rank(rank, k), kind="stable")
        got = TC.next_rank_order_ref(torch.from_numpy(order.copy()), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k = {k}")


@pytest.mark.parametrize("case", NEXT_RANK_CASES)
def test_previous_order_is_stable_argsort_of_rank(case):
    """Each round's order is the stable argsort of the ranks it produced,
    so the next round may start from it; and one stable sort by rank of
    the next-rank order gives the round's order."""
    ranks, ks = _next_rank_case(case)
    rounds = _jax_rounds(ranks, ks)
    for (rank, k, order), nxt in zip(rounds, rounds[1:] + [None]):
        np.testing.assert_array_equal(order,
                                      np.argsort(rank, kind="stable"))
        seq = TC.next_rank_order_ref(torch.from_numpy(order.copy()),
                                     k).numpy()
        want = np.asarray(CJ._doubling_round(jnp.asarray(rank),
                                             jnp.int32(k))[0])
        np.testing.assert_array_equal(
            seq[np.argsort(rank[seq], kind="stable")], want)
        if nxt is not None:
            np.testing.assert_array_equal(nxt[2], want)


@pytest.mark.parametrize("max_rank,passes", [(0, 1), (1, 1), (255, 1),
                                             (256, 2), (4_000_003, 3),
                                             (72_000_015, 4),
                                             (2**31 - 1, 4)])
def test_key_passes(max_rank, passes):
    """8-bit digits over bit_length(max rank) bits: 3 passes at bench's
    n = 4M, 4 at the pangenome's 72M; 6 and 7 launches a round."""
    assert TC.key_passes(max_rank) == passes
    assert TC.round_launches(passes, True) == 3 + passes
    assert TC.round_launches(passes, False) == 3 + 2 * passes


def test_doubling_round_cpu_ignores_order():
    """On the CPU the plain version runs, with or without an order."""
    ranks = _ranks(_collection(5)).astype(np.int32)
    rank = torch.from_numpy(ranks)
    order = torch.sort(rank, stable=True).indices.to(torch.int32)
    for got in (TC.doubling_round(rank, 4, int(ranks.max()), order),
                TC.doubling_round(rank, 4, int(ranks.max()))):
        for g, w in zip(got, TC.doubling_round_ref(rank, 4)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("case", [0, 1, 2, 3, "repetitive", "one doc"])
def test_suffix_array_matches_jax(case):
    """sa, rank, the number of rounds and every pyramid level."""
    docs = {"repetitive": REPETITIVE,
            "one doc": [b"GATTACA" * 9]}.get(case) or _collection(case)
    ranks = _ranks(docs)
    sa_j, rank_j, pyr_j = CJ.suffix_array_jax(ranks, with_pyramid=True)
    sa, rank, pyr = TC.suffix_array(ranks, with_pyramid=True, device=CPU)
    assert sa.dtype == rank.dtype == torch.int32
    np.testing.assert_array_equal(sa.numpy(), sa_j)
    np.testing.assert_array_equal(rank.numpy(), rank_j)
    assert len(pyr) == len(pyr_j)
    for j, (p, w) in enumerate(zip(pyr, pyr_j)):
        np.testing.assert_array_equal(p.numpy(), w, err_msg=f"level {j}")
    np.testing.assert_array_equal(sa.numpy(), O.suffix_array(ranks))
    sa2, rank2 = TC.suffix_array(ranks, device=CPU)
    assert torch.equal(sa2, sa) and torch.equal(rank2, rank)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_suffix_array_tiny(n):
    """n = 1 (one empty document), 2 and 3: one round, as in JAX."""
    ranks = _ranks([[b"", b"A", b"AC"][n - 1]])
    assert ranks.size == n
    sa_j, _, pyr_j = CJ.suffix_array_jax(ranks, with_pyramid=True)
    sa, _, pyr = TC.suffix_array(ranks, with_pyramid=True, device=CPU)
    np.testing.assert_array_equal(sa.numpy(), sa_j)
    assert len(pyr) == len(pyr_j)
    lcp = TC.lcp_from_pyramid(ranks, sa, pyr)
    np.testing.assert_array_equal(lcp.numpy(), CJ.lcp_jax(ranks, sa_j, pyr_j))


@pytest.mark.parametrize("case", [0, 1, "repetitive"])
def test_lcp_from_pyramid_matches_jax_and_kasai(case):
    docs = REPETITIVE if case == "repetitive" else _collection(10 + case)
    ranks = _ranks(docs)
    sa_j, _, pyr_j = CJ.suffix_array_jax(ranks, with_pyramid=True)
    want = CJ.lcp_jax(ranks, sa_j, pyr_j)
    sa, _, pyr = TC.suffix_array(ranks, with_pyramid=True, device=CPU)
    for r0 in (ranks, torch.from_numpy(ranks.astype(np.int32))):
        got = TC.lcp_from_pyramid(r0, sa, pyr)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TC.lcp_from_pyramid_ref(torch.from_numpy(ranks.astype(np.int32)),
                                sa, pyr).numpy(), want)
    np.testing.assert_array_equal(want, O.lcp_kasai(ranks, sa_j))


# K11b's walk (csrc/suffix.cu lcp_walk_kernel, lcp_gather_kernel) in
# NumPy, thread by thread: the layouts' partitions of the text, a thread's
# first position by the full lift, the carried bound, the gallop, the
# descent and the cap, the values stored in text order and gathered into
# SA order.  The kernel
# runs on the card only; this model holds the walk's logic to JAX's lift
# on the texts that break such walks.
_SUFFIX_CU = Path(TC.__file__).resolve().parents[1] / "csrc" / "suffix.cu"


# K12's kernels (csrc/suffix.cu argmin_tile_kernel, argmin_finish_kernel)
# in NumPy: tiles of P positions from the span's first position rounded
# down to a multiple of 32, a block a run of consecutive tiles, its first
# tile's first segment by the warp's 32-way search and the next tiles' by
# the walk, a position's segment by the prefix count of the segments'
# start marks, a lane's P / 32 consecutive positions reduced run by run
# into shared keys, inside segments stored at once, crossing ones min-ed into
# the key of the tile where they start and unpacked by the second kernel.  The kernels run on the card only; this model holds
# the split to JAX's two segment_min passes and to the plain version.
_KEY_MAX = np.uint64(2**64 - 1)


def argmin_key(lcp, pos):
    """(lcp ^ 2**31) << 32 | position, as uint64: unsigned order is (lcp,
    position) order for every int32 lcp and position < 2**31."""
    flipped = (np.asarray(lcp, np.int64) & 0xFFFFFFFF) ^ 0x80000000
    return (flipped.astype(np.uint64) << np.uint64(32)) | np.asarray(
        pos, np.uint64)


def first_segment_model(hi, a):
    """The first g with hi[g] >= a, as the kernel's warp finds it (32
    probes a round; hi[-1] >= a)."""
    l, h = 0, hi.size - 1
    while l < h:
        step = (h - l + 31) // 32
        ok = hi[np.minimum(l + np.arange(32) * step, h)] >= a
        if not ok.any():
            l = l + 31 * step + 1
        else:
            f = int(np.argmax(ok))
            h = min(l + f * step, h)
            l = h if f == 0 else l + (f - 1) * step + 1
    return l


def argmin_tile_model(lcp, lo, hi, P, per_block):
    """segmented_argmin's output by the kernels' split into tiles of P, a
    block `per_block` consecutive tiles."""
    n, m = lcp.size, lo.size
    keys = argmin_key(lcp, np.arange(n))
    tiles = -(-n // P)
    part = np.full(tiles, _KEY_MAX, np.uint64)
    owner = np.full(tiles, -1, np.int64)
    out = np.full(m, -9, np.int64)
    span0, span_end = int(lo[0]) // 32 * 32, int(hi[-1]) + 1
    for b in range(tiles):
        a = span0 + b * P
        if a >= span_end:
            continue
        if b % per_block == 0:
            g0 = first_segment_model(hi, a)
        assert g0 == np.searchsorted(hi, a)
        e = min(a + P, span_end)
        length = e - a
        gs = np.arange(g0, g0 + np.searchsorted(lo[g0:], e))
        ends = np.where(hi[gs] < e, hi[gs] - a, length)
        marks = np.zeros(P, bool)
        marks[np.maximum(lo[gs], a) - a] = True
        q = np.arange(length)
        v = np.cumsum(marks)[:length] - 1
        inseg = (v >= 0) & (q <= ends[np.maximum(v, 0)])
        seg_key = np.full(gs.size, _KEY_MAX, np.uint64)
        per = P // 32
        for q0 in range(0, length, per):  # a lane's positions
            mine = np.arange(q0, min(q0 + per, length))
            mine = mine[inseg[mine]]
            for u in np.unique(v[mine]):  # a run of one segment: its min
                run = mine[v[mine] == u]
                assert np.all(np.diff(run) == 1)
                seg_key[u] = min(seg_key[u], keys[a + run].min())
        for u, g in enumerate(gs):
            if lo[g] >= a and hi[g] < e:
                assert out[g] == -9
                out[g] = int(seg_key[u] & np.uint64(0xFFFFFFFF))
            else:
                if lo[g] >= a:
                    owner[b] = g
                t = (lo[g] - span0) // P
                part[t] = min(part[t], seg_key[u])
        # the walk: the next tile starts at this one's last segment if it
        # crosses, else after it
        g0 = g0 + gs.size - int(gs.size > 0 and ends[-1] == length)
    for b in np.flatnonzero(part != _KEY_MAX):
        out[owner[b]] = int(part[b] & np.uint64(0xFFFFFFFF))
    assert (out >= 0).all()
    return out


def _shipped_arg_tile():
    return int(re.search(r"constexpr int kArgTile = (\d+);",
                         _SUFFIX_CU.read_text()).group(1))


def test_argmin_key_orders_as_lcp_then_position():
    rng = np.random.default_rng(11)
    lcp = np.r_[rng.integers(-2**31, 2**31, 2000), -2**31, 2**31 - 1, -1, 0,
                0, 0].astype(np.int32)
    pos = np.r_[rng.integers(0, 2**31, 2000), 7, 7, 7, 5, 0, 2**31 - 1]
    want = np.lexsort((pos, lcp))
    np.testing.assert_array_equal(np.argsort(argmin_key(lcp, pos),
                                             kind="stable"), want)


def test_argmin_tile_constants():
    """The wrapper's tile (its workspace: a key a tile) is the kernel's."""
    assert TC._ARGMIN_TILE == _shipped_arg_tile()
    P = TC._ARGMIN_TILE
    for n in (1, P - 1, P, P + 1, 4_000_004):
        assert TC.argmin_tiles(n) == -(-n // P)
    ws = TC.ArgminWorkspace(2 * P + 1, torch.device("cpu"))
    assert ws.keys.shape == (3,) and bool((ws.keys == -1).all())
    assert ws.owner.shape == (3,)


@pytest.mark.parametrize("P", [32, "shipped"])
@pytest.mark.parametrize("name", ("collection",) + ARGMIN_CASES)
def test_argmin_tile_model_matches_jax(name, P):
    """The tile split at a tile of 32 and at the shipped one, a tile a
    block and runs of 3 tiles (the walk), on the segments of a collection's
    BWT and on K12's edge cases, against JAX's _segmented_argmin and the
    plain version."""
    P = _shipped_arg_tile() if P == "shipped" else P
    if name == "collection":
        heads, lens, lcp = _bwt_case(random_docs(np.random.default_rng(5), 3,
                                                 lo=200, hi=400))
        lcp = lcp.astype(np.int32)
        segs = [(lo, hi) for _, lo, hi in TC.threshold_segments(heads, lens)]
    else:
        lcp, segs = argmin_case(name, P)
    n = lcp.size
    crossing = 0
    for lo, hi in segs:
        lo, hi = lo.astype(np.int64), hi.astype(np.int64)
        bounds = np.empty(2 * lo.size, dtype=np.int64)
        bounds[0::2], bounds[1::2] = lo, hi + 1
        pos_seg = np.searchsorted(bounds, np.arange(n), side="right")
        seg_id = np.where(pos_seg % 2 == 1, pos_seg // 2, lo.size)
        want = np.asarray(CJ._segmented_argmin(
            jnp.asarray(lcp), jnp.asarray(seg_id, jnp.int32),
            lo.size + 1))[:lo.size]
        for per_block in (1, 3):
            np.testing.assert_array_equal(
                argmin_tile_model(lcp, lo, hi, P, per_block), want)
        np.testing.assert_array_equal(TC.segmented_argmin_ref(
            torch.from_numpy(lcp), torch.from_numpy(lo),
            torch.from_numpy(hi)).numpy(), want)
        crossing += int(((lo - lo[0]) // P != (hi - lo[0]) // P).sum())
    # segments that cross tiles, where the case has any at a tile of 32
    if P == 32 and name not in ("segments of length 1", "m = 1 inside a tile",
                                "ends on tile edges"):
        assert crossing > 0


def _shipped_layout():
    """(kLcpSpan, kLcpGroup) as csrc/suffix.cu ships them."""
    src = _SUFFIX_CU.read_text()
    span = re.search(r"constexpr int kLcpSpan = (\d+);", src)
    group = re.search(r"constexpr int kLcpGroup = (\d+);", src)
    return int(span.group(1)), int(group.group(1))


def lcp_walk_model(ranks0, sa, pyramid, span, group):
    """The int64 LCP array as the kernels compute it; every text position
    is written once (a position left unwritten stays -7)."""
    n = sa.size
    levels = [np.asarray(ranks0, np.int64)] + [np.asarray(p, np.int64)
                                               for p in pyramid]
    R = len(pyramid)
    cap = (2 << R) - 1
    # the kernels' test: the top level's rank of sa's last suffix, which is
    # its largest rank (dense ranks grow along sa)
    top_is_inverse = bool(R) and levels[-1][sa[-1]] == n - 1
    assert top_is_inverse == (bool(R) and levels[-1].max() == n - 1)
    if top_is_inverse:
        isa = levels[-1]
    else:  # the entry point's scatter
        isa = np.empty(n, np.int64)
        isa[sa] = np.arange(n)

    def same(l, a, b):
        ra = levels[l][a] if a < n else -1
        rb = levels[l][b] if b < n else -2
        return ra == rb

    def lift(a, b):
        h = 0
        for l in range(R, -1, -1):
            if same(l, a + h, b + h):
                h += 1 << l
        return h

    def extend(a, b, h):
        l = 0
        while l <= R and h + (1 << l) <= cap and same(l, a + h, b + h):
            h += 1 << l
            l += 1
        while l > 0:
            l -= 1
            if h + (1 << l) <= cap and same(l, a + h, b + h):
                h += 1 << l
        return h

    plcp = np.full(n, -7, np.int64)
    threads = -(-n // (span * 32)) * 32
    for t in range(threads):
        first = t // group * group * span + t % group
        h = -1
        for i in range(span):
            p = first + i * group
            if p >= n:
                break
            j = int(isa[p])
            assert plcp[p] == -7, f"plcp[{p}] written twice"
            if j == 0:
                plcp[p] = h = 0
                continue
            q = int(sa[j - 1])
            h = lift(q, p) if h < 0 else extend(q, p, max(h - group, 0))
            plcp[p] = h
    lcp = plcp[sa]
    lcp[0] = 0
    return lcp


def _walk_docs(case):
    rng = np.random.default_rng(0x11B)
    if isinstance(case, int):  # one document making n = case positions
        return [bytes(rng.choice(list(b"ACGT"), case - 1).astype("uint8"))]
    return {"one letter": [b"A" * 200],
            "period 2": [b"AC" * 90],
            "period 3": [b"ACG" * 60, b"ACGA" * 20],
            "repetitive": REPETITIVE,
            "collection": _collection(21),
            "pangenome": random_docs(
                rng, 4, mutate_from=bytes(rng.choice(
                    list(b"ACGT"), 600).astype("uint8")))}[case]


@functools.lru_cache(maxsize=None)
def _walk_case(case, levels):
    """ranks, sa, the pyramid (its first `levels` levels, or all of it) and
    JAX's lift on them."""
    ranks = _ranks(_walk_docs(case))
    sa, _, pyr = CJ.suffix_array_jax(ranks, with_pyramid=True)
    pyr = [np.asarray(p) for p in pyr][:levels]
    return ranks, np.asarray(sa), pyr, CJ.lcp_jax(ranks, sa, pyr)


WALK_CASES = ["one letter", "period 2", "period 3", "repetitive",
              "collection", "pangenome", 1, 2, 127, 129, 255, 257]
# (span, group): the shipped layout, lanes a run apart (group 1), side by
# side in groups of 4 and 8 and a warp's 32, with spans that do not
# divide n
WALK_LAYOUTS = ["shipped", (16, 1), (5, 1), (1, 1), (7, 4), (16, 8),
                (16, 32), (3, 32)]


@pytest.mark.parametrize("layout", WALK_LAYOUTS, ids=str)
@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_lcp_walk_model_matches_jax(case, layout):
    span, group = _shipped_layout() if layout == "shipped" else layout
    ranks, sa, pyr, want = _walk_case(case, None)
    got = lcp_walk_model(ranks, sa, pyr, span, group)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TC.lcp_from_pyramid_ref(torch.from_numpy(ranks.astype(np.int32)),
                                torch.from_numpy(sa),
                                [torch.from_numpy(p) for p in pyr]).numpy(),
        want)


@pytest.mark.parametrize("layout", ["shipped", (16, 1), (3, 32)], ids=str)
@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("case", ["one letter", "period 3", "repetitive"])
def test_lcp_walk_model_cut_pyramid(case, levels, layout):
    """The first `levels` levels only: the cap 2**(levels+1) - 1 binds, the
    top level is no inverse suffix array, and the walk's carried bound must
    stay under the cap."""
    span, group = _shipped_layout() if layout == "shipped" else layout
    ranks, sa, pyr, want = _walk_case(case, levels)
    assert len(pyr) == levels and want.max() == (2 << levels) - 1
    np.testing.assert_array_equal(lcp_walk_model(ranks, sa, pyr, span, group),
                                  want)
    got = TC.lcp_from_pyramid(ranks, torch.from_numpy(sa),
                              [torch.from_numpy(p) for p in pyr])
    np.testing.assert_array_equal(got.numpy(), want)


def _bwt_case(docs):
    text, ranks, _ = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    return heads, lens, lcp


def test_segmented_argmin_matches_jax(rng):
    """One character's segments, as compute_thresholds_jax builds them:
    the plain two segment-min passes against JAX's, ties included."""
    heads, lens, lcp = _bwt_case(random_docs(rng, 3, lo=60, hi=120))
    checked = 0
    for runs, lo, hi in TC.threshold_segments(heads, lens):
        n = int(lens.sum())
        seg_bounds = np.empty(2 * lo.size, dtype=np.int64)
        seg_bounds[0::2], seg_bounds[1::2] = lo, hi + 1
        pos_seg = np.searchsorted(seg_bounds, np.arange(n), side="right")
        seg_id = np.where(pos_seg % 2 == 1, pos_seg // 2, lo.size)
        want = np.asarray(CJ._segmented_argmin(
            jnp.asarray(lcp, jnp.int32), jnp.asarray(seg_id, jnp.int32),
            lo.size + 1))[:lo.size]
        lcp_t = torch.from_numpy(lcp.astype(np.int32))
        for fn in (TC.segmented_argmin_ref, TC.segmented_argmin):
            got = fn(lcp_t, torch.from_numpy(lo), torch.from_numpy(hi))
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
        checked += lo.size
    assert checked > 0


@pytest.mark.parametrize("case", [0, 1, "single run"])
def test_compute_thresholds_matches_jax_and_oracle(case):
    if case == "single run":
        # 'G' (71) has one run: skipped, threshold 0; ties in the lcp
        heads = np.array([65, 67, 65, 71, 67, 1, 65, 67], dtype=np.uint8)
        lens = np.array([2, 3, 1, 2, 2, 1, 3, 1], dtype=np.int64)
        lcp = np.array([0, 2, 1, 1, 3, 0, 0, 2, 4, 2, 1, 1, 5, 1, 0],
                       dtype=np.int64)
    else:
        heads, lens, lcp = _bwt_case(_collection(20 + case))
    want = O.compute_thresholds(heads, lens, lcp)
    np.testing.assert_array_equal(CJ.compute_thresholds_jax(heads, lens, lcp),
                                  want)
    for arg in (lcp, torch.from_numpy(lcp)):
        got = TC.compute_thresholds(heads, lens, arg, device=CPU)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_compute_thresholds_refuses_wide_n():
    with pytest.raises(ValueError, match="2\\*\\*31"):
        TC.compute_thresholds(np.array([65, 67], np.uint8),
                              np.array([2**31 - 1, 1], np.int64),
                              np.zeros(4, np.int32), device=CPU)


# ---------------------------------------------------------------------------
# the build's route without the native library
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def no_native(tmp_path_factory):
    """The goldens' collection built by both packages with the native
    library hidden and _DEVICE_MIN_N lowered below its n (JAX's device
    suffix array, the port's TC.suffix_array with its plain versions), and
    by the port with _DEVICE_MIN_N above its n (the oracle).  Returns the
    directory and the calls each route made."""
    tmp = tmp_path_factory.mktemp("no_native")
    for f in ("seq1.fa", "seq2.fa"):
        shutil.copy(GOLD / f, tmp / f)
    fastas = [str(tmp / "seq1.fa"), str(tmp / "seq2.fa")]
    calls = {"device": [], "oracle": []}
    real_sa, real_oracle = TC.suffix_array, TO.suffix_array

    def device_sa(ranks, *a, **kw):
        calls["device"].append(np.asarray(ranks).size)
        return real_sa(ranks, *a, **kw)

    def oracle_sa(ranks):
        calls["oracle"].append(np.asarray(ranks).size)
        return real_oracle(ranks)

    with pytest.MonkeyPatch.context() as mp:
        for lib in (JN, TN):
            mp.setattr(lib, "available", lambda: False)
        mp.setattr(TC, "suffix_array", device_sa)
        mp.setattr(TO, "suffix_array", oracle_sa)
        for mod in (JB, TB):
            mp.setattr(mod, "_DEVICE_MIN_N", 1 << 10)
        jax_build(fastas, str(tmp / "jax"), ColBwtConfig(**CFG))
        build_pipeline(fastas, str(tmp / "torch"), ColBwtConfig(**CFG),
                       device=CPU)
        routed = {k: list(v) for k, v in calls.items()}
        mp.setattr(TB, "_DEVICE_MIN_N", 1 << 20)
        build_pipeline(fastas, str(tmp / "small"), ColBwtConfig(**CFG),
                       device=CPU)
    return tmp, routed, calls


@pytest.mark.parametrize("ext", ARTIFACTS)
def test_no_native_artifacts_match_jax(no_native, ext):
    tmp, _, _ = no_native
    want = (tmp / f"jax.{ext}").read_bytes()
    assert (tmp / f"torch.{ext}").read_bytes() == want
    assert (tmp / f"small.{ext}").read_bytes() == want


def test_no_native_index_arrays_match_jax(no_native):
    tmp, _, _ = no_native
    a = np.load(tmp / "torch.colpml.npz")
    b = np.load(tmp / "jax.colpml.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_no_native_routes(no_native):
    """From _DEVICE_MIN_N the port's build went through TC.suffix_array
    and never the oracle; below it, through the oracle alone."""
    _, routed, calls = no_native
    assert len(routed["device"]) == 1 and routed["device"][0] >= 1 << 10
    assert routed["oracle"] == []
    assert calls["device"] == routed["device"]
    assert calls["oracle"] == routed["device"]


def test_bench_build_sequence_matches_jax(rng, tmp_path):
    """bench.py:83-98 with the native library absent, at a small size: the
    device SA and LCP, multi-MUMs, col-split, run sweep, device thresholds
    and the ff_bound-2 index, through the port's ops and through JAX's."""
    base = bytes(rng.choice(list(b"ACGT"), 600).astype("uint8"))
    docs = random_docs(rng, 4, mutate_from=base)
    text, ranks, doc_ids = O.concat_collection(docs)

    def sequence(sa, lcp, mums, col_split, thresholds, index_cls):
        heads, lens = O.rle(O.bwt_from_sa(text, sa))
        fl = O.build_fl_table(heads, lens)
        ml, mp = mums(ranks, sa, lcp, doc_ids, 4, 8)
        assert ml.size > 0
        mpos, mids, mhts = col_split(fl, ml, mp, 4, 10, "tunnels")
        bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads,
                                           fl.n)
        tbl = O.build_col_pml(heads, lens, bits, ids,
                              thresholds(heads, lens, lcp))
        return index_cls.build(tbl, ff_bound=2)

    sa_j, _, pyr_j = CJ.suffix_array_jax(ranks, with_pyramid=True)
    want = sequence(sa_j, CJ.lcp_jax(ranks, sa_j, pyr_j),
                    CJ.find_multi_mums_jax, col_split_jax,
                    CJ.compute_thresholds_jax, JIndex)
    sa_t, _, pyr = TC.suffix_array(ranks, with_pyramid=True, device=CPU)
    lcp = TC.lcp_from_pyramid(ranks, sa_t, pyr).numpy()
    got = sequence(
        sa_t.numpy(), lcp,
        lambda *a: TC.find_multi_mums(*a, device=CPU),
        lambda *a: TCS.col_split(*a, device=CPU),
        lambda *a: TC.compute_thresholds(*a, device=CPU), TIndex)
    want.save(tmp_path / "jax")
    got.save(tmp_path / "torch")
    a, b = np.load(tmp_path / "torch.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
