"""The port's col-split walk (colbwt_tpu_torch/ops/colsplit.py) against the
JAX package's (ops/colsplit_jax.py) and the host oracle, on the CPU, where
the plain PyTorch versions of K10a and K10b run.  Every value is an
integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.ops import colsplit_jax as CS
from colbwt_tpu.ops import oracle as O
from colbwt_tpu_torch.ops import colsplit as TCS
from tests.conftest import random_docs


def _collection(rng, num_docs, base_len, min_mum):
    base = bytes(rng.choice(list(b"ACGT"), base_len).astype("uint8"))
    docs = random_docs(rng, num_docs, mutate_from=base)
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, num_docs, min_mum)
    assert ml.size > 0
    return fl, ml, mp


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _walk_inputs(fl, ml, mp):
    order = np.argsort(mp, kind="stable")
    p0 = mp[order].astype(np.int32)
    lens = ml[order].astype(np.int32)
    fd_t = TCS.fl_tensors(fl, "cpu")
    fd_j = CS.fl_device_arrays(fl)
    return (fd_t, torch.from_numpy(p0), torch.from_numpy(lens),
            fd_j, jnp.asarray(p0), jnp.asarray(lens), int(lens.max()))


@pytest.mark.parametrize("num_docs,rate", [(2, 1), (3, 3), (4, 10)])
def test_tunneled_walk_matches_jax(rng, num_docs, rate):
    fl, ml, mp = _collection(rng, num_docs, 300, 6)
    fd, p0, lens, fdj, p0j, lensj, T = _walk_inputs(fl, ml, mp)
    want = CS._tunneled_walk(fdj, p0j, lensj, T + 3, rate, num_docs)
    for fn in (TCS.tunneled_walk_ref, TCS.tunneled_walk):
        got = fn(fd, p0, lens, T + 3, rate, num_docs)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        _assert_same([x.numpy() for x in got], want)
    assert bool(got[1].any())


@pytest.mark.parametrize("num_docs,rate", [(2, 1), (3, 2), (5, 3)])
def test_all_walk_matches_jax(rng, num_docs, rate):
    fl, ml, mp = _collection(rng, num_docs, 300, 6)
    fd, p0, lens, fdj, p0j, lensj, T = _walk_inputs(fl, ml, mp)
    want = CS._all_walk(fdj, p0j, lensj, T, rate, num_docs)
    for fn in (TCS.all_walk_ref, TCS.all_walk):
        got = fn(fd, p0, lens, T, rate, num_docs)
        _assert_same([x.numpy() for x in got], want)
    assert bool((got[1][got[2]] < num_docs).any())  # fragments did split


def test_fl_unit_matches_jax(rng):
    fl, _, _ = _collection(rng, 3, 200, 6)
    p = rng.integers(0, fl.n, 500).astype(np.int32)
    want = CS._fl_unit(CS.fl_device_arrays(fl), jnp.asarray(p))
    got = TCS.fl_unit_ref(TCS.fl_tensors(fl, "cpu"), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,rate", [("tunnels", 1), ("tunnels", 2),
                                       ("tunnels", 3), ("all", 1),
                                       ("all", 2), ("all", 3)])
def test_col_split_matches_jax_and_oracle(rng, mode, rate):
    fl, ml, mp = _collection(rng, 3, 250, 6)
    got = TCS.col_split(fl, ml, mp, 3, rate, mode, device="cpu")
    _assert_same(got, CS.col_split_jax(fl, ml, mp, 3, rate, mode))
    _assert_same(got, O.col_split_oracle(fl, ml, mp, 3, rate, mode))
    assert got[0].dtype == np.int64 and got[0].size > 0


@pytest.mark.parametrize("mode", ["tunnels", "all"])
def test_col_split_bucketing(rng, mode):
    """A step budget of 8 forces many buckets; results are unchanged and
    equal JAX's under the same budget."""
    fl, ml, mp = _collection(rng, 4, 300, 5)
    ref = TCS.col_split(fl, ml, mp, 4, 2, mode, device="cpu")
    small = TCS.col_split(fl, ml, mp, 4, 2, mode, step_budget=8,
                          device="cpu")
    _assert_same(small, ref)
    _assert_same(small, CS.col_split_jax(fl, ml, mp, 4, 2, mode,
                                         step_budget=8))
    order = np.argsort(mp, kind="stable")
    ls = ml[order]
    sizes = [b.size for b in TCS.buckets(ls, np.argsort(ls, kind="stable"),
                                         mode == "tunnels", 4, 8)]
    assert sum(sizes) == ml.size and len(sizes) > 1


def test_col_split_all_mode_many_docs_walks_on_host(rng, monkeypatch):
    """All mode at N = 96 (> 64) takes the host fragment-event walk, as
    col_split_jax does; it equals the oracle."""
    base = bytes(rng.choice(list(b"ACGT"), 120).astype("uint8"))
    docs = []
    for _ in range(96):  # one SNP per copy so length-5 multi-MUMs survive
        arr = bytearray(base)
        arr[int(rng.integers(0, len(arr)))] = b"ACGT"[int(rng.integers(0, 4))]
        docs.append(bytes(arr))
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, 96, 5)
    assert ml.size > 0

    def no_walk(*a, **kw):
        raise AssertionError("the device walk must not run at N > 64")

    monkeypatch.setattr(TCS, "all_walk", no_walk)
    for rate in (1, 3):
        got = TCS.col_split(fl, ml, mp, 96, rate, "all", device="cpu")
        _assert_same(got, O.col_split_oracle(fl, ml, mp, 96, rate, "all"))
        _assert_same(got, CS.col_split_jax(fl, ml, mp, 96, rate, "all"))


@pytest.mark.parametrize("seed,num_docs,rate", [(1, 2, 2), (2, 3, 3),
                                                (3, 4, 1)])
def test_colsplit_host_matches_jax_and_oracle(seed, num_docs, rate):
    """The host int64 tunneled walk (the wide lane)."""
    rng = np.random.default_rng(seed)
    fl, ml, mp = _collection(rng, num_docs, 300, 8)
    got = TCS.col_split_tunneled_numpy(fl, ml, mp, num_docs, rate)
    for want in (CS.col_split_tunneled_numpy(fl, ml, mp, num_docs, rate),
                 O.col_split_oracle(fl, ml, mp, num_docs, rate, "tunnels")):
        _assert_same(got, want)


@pytest.mark.parametrize("seed,num_docs,rate", [(4, 2, 1), (5, 3, 2),
                                                (6, 5, 3)])
def test_col_split_all_numpy_matches_jax_and_oracle(seed, num_docs, rate):
    """The host fragment-event walk of all mode."""
    rng = np.random.default_rng(seed)
    fl, ml, mp = _collection(rng, num_docs, 300, 6)
    got = TCS.col_split_all_numpy(fl, ml, mp, num_docs, rate)
    for want in (CS.col_split_all_numpy(fl, ml, mp, num_docs, rate),
                 O.col_split_oracle(fl, ml, mp, num_docs, rate, "all")):
        _assert_same(got, want)


def test_col_split_no_mums():
    fl = O.build_fl_table(np.array([65, 1], np.uint8), np.array([3, 1]))
    z = np.empty(0, dtype=np.int64)
    for mode in ("tunnels", "all"):
        _assert_same(TCS.col_split(fl, z, z, 2, 1, mode, device="cpu"),
                     (z, z, z))


# ---------------------------------------------------------------------------
# K10a's move-structure walk, modelled in NumPy (csrc/colsplit.cu)
# ---------------------------------------------------------------------------

INT32_MAX = (1 << 31) - 1


def _wrap(x):
    """int64 values wrapped to int32's range, as int32 sums wrap."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def walk_model(rows, p0, num_steps, num_docs, max_forward=8):
    """The kernel's walk over `rows` (TCS.walk_rows), every walker in
    lockstep: the carried run count u, the alive test against the row's
    start and next start, the step from the row, the fast-forward from
    clip(dest_interval) (at most `max_forward` rows) or the binary search.
    Each identity is checked against searchsorted at every step.  Returns
    pos (T, M) int32, alive (T, M) and the fast-forward rows a step (T, M;
    -1 where the binary search took over)."""
    start, nxt, head, dest = (rows[:, c].astype(np.int64) for c in range(4))
    r = start.size
    p = np.asarray(p0, np.int64)
    M = p.size
    u = np.searchsorted(start, p, side="right")
    alive = np.ones(M, bool)
    pos = np.empty((num_steps, M), np.int32)
    alive_t = np.empty((num_steps, M), bool)
    ff = np.empty((num_steps, M), np.int64)
    for t in range(num_steps):
        j = np.maximum(u - 1, 0)
        q = _wrap(p + num_docs - 1)
        whole = np.where(u == 0, q < start[j],
                         (start[j] <= q) & ((u == r) | (q < nxt[j])))
        assert np.array_equal(whole,
                              np.searchsorted(start, q, side="right") == u)
        alive &= whole
        p = _wrap(head[j] + _wrap(p - start[j]))
        pos[t] = p
        alive_t[t] = alive
        jj = dest[j].copy()
        f = np.zeros(M, np.int64)
        ok = p >= start[jj]

        def inside(jj):
            return (jj == r - 1) | (p < nxt[jj])

        go = ok & ~inside(jj)
        for _ in range(max_forward):
            if not go.any():
                break
            jj[go] += 1
            f[go] += 1
            go &= ~inside(jj)
        found = ok & inside(jj)
        u = np.where(found, jj + 1, np.searchsorted(start, p, side="right"))
        assert np.array_equal(u, np.searchsorted(start, p, side="right"))
        ff[t] = np.where(found, f, -1)
    return pos, alive_t, ff


def test_walk_rows_match_jax_gathers(rng):
    """The row table: idx, the next start, dest_head = JAX's int32
    idx[clip(di)] + doff, clip(di)."""
    fl, _, _ = _collection(rng, 4, 300, 6)
    fd = TCS.fl_tensors(fl, "cpu")
    rows = fd["rows"].numpy()
    fdj = CS.fl_device_arrays(fl)
    r = fl.idx.size
    di = jnp.clip(fdj["dest_interval"], 0, r - 1)
    want_head = jnp.take(fdj["idx"], di, mode="clip") + fdj["dest_offset"]
    assert rows.dtype == np.int32 and rows.shape == (r, 4)
    np.testing.assert_array_equal(rows[:, 0], np.asarray(fdj["idx"]))
    np.testing.assert_array_equal(rows[:, 1], np.r_[np.asarray(fl.idx)[1:],
                                                    INT32_MAX])
    np.testing.assert_array_equal(rows[:, 2], np.asarray(want_head))
    np.testing.assert_array_equal(rows[:, 3], np.asarray(di))


def test_walk_rows_wrap():
    """dest_head wraps as JAX's int32 sum does."""
    fd = {"idx": torch.tensor([0, 5, INT32_MAX - 3], dtype=torch.int32),
          "dest_interval": torch.tensor([2, 7, -1], dtype=torch.int32),
          "dest_offset": torch.tensor([9, 1, 2], dtype=torch.int32)}
    rows = TCS.walk_rows(fd).numpy()
    want = jnp.asarray([INT32_MAX - 3, INT32_MAX - 3, 0], jnp.int32) \
        + jnp.asarray([9, 1, 2], jnp.int32)
    np.testing.assert_array_equal(rows[:, 2], np.asarray(want))
    np.testing.assert_array_equal(rows[:, 3], [2, 2, 0])


def _edge_starts(fl, p0, num_docs, rng):
    """MUM starts plus the walk's edge cases: the last run, within N - 1 of
    n, past n, negative, and near 2**31 (q wraps)."""
    n, last = int(fl.n), int(fl.idx[-1])
    extra = [last, n - 1, max(n - num_docs + 1, 0), n, n + 7, -1, -50,
             INT32_MAX, INT32_MAX - num_docs + 2, INT32_MAX - 1,
             -(1 << 31)] + list(rng.integers(last, n, 4))
    return np.r_[p0, np.asarray(extra, np.int64)].astype(np.int32)


@pytest.mark.parametrize("num_docs,rate,max_forward",
                         [(2, 1, 8), (3, 3, 8), (4, 10, 8), (4, 10, 1),
                          (3, 2, 0), (8, 4, 8)])
def test_walk_model_matches_plain_and_jax(rng, num_docs, rate, max_forward):
    """The kernel's identities on every step of every walker of random
    collections (checked inside walk_model), its planes equal to the plain
    version's and JAX's; max_forward 0 and 1 force the binary search."""
    fl, ml, mp = _collection(rng, num_docs, 300, 6)
    order = np.argsort(mp, kind="stable")
    p0 = _edge_starts(fl, mp[order], num_docs, rng)
    lens = np.r_[ml[order], rng.integers(1, 40, p0.size - ml.size)]
    lens = lens.astype(np.int32)
    T = int(lens.max()) + 3
    fd = TCS.fl_tensors(fl, "cpu")
    pos, alive, ff = walk_model(fd["rows"].numpy(), p0, T, num_docs,
                                max_forward)
    t = np.arange(T)[:, None]
    valid = alive & (t % rate == 0) & (t < lens[None, :])
    got = TCS.tunneled_walk_ref(fd, torch.from_numpy(p0),
                                torch.from_numpy(lens), T, rate, num_docs)
    np.testing.assert_array_equal(pos, got[0].numpy())
    np.testing.assert_array_equal(valid, got[1].numpy())
    want = CS._tunneled_walk(CS.fl_device_arrays(fl), jnp.asarray(p0),
                             jnp.asarray(lens), T, rate, num_docs)
    np.testing.assert_array_equal(pos, np.asarray(want[0]))
    np.testing.assert_array_equal(valid, np.asarray(want[1]))
    assert (ff >= -1).all() and valid.any()
    if max_forward == 0:
        assert (ff <= 0).all()  # every step found in place or searched


# ---------------------------------------------------------------------------
# K10b's all-mode walk, modelled in NumPy (csrc/colsplit.cu all_walk_kernel)
# ---------------------------------------------------------------------------

def locate_model(rows, dest, p, max_forward=8):
    """K10a's `locate` for many walkers: u = searchsorted(start, p,
    "right") from the row of run `dest` by at most `max_forward` rows of
    fast-forward, else the binary search; checked against searchsorted."""
    start, nxt = rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64)
    r = start.size
    jj = np.asarray(dest, np.int64).copy()
    ok = p >= start[jj]

    def inside(jj):
        return (jj == r - 1) | (p < nxt[jj])

    go = ok & ~inside(jj)
    for _ in range(max_forward):
        if not go.any():
            break
        jj[go] += 1
        go &= ~inside(jj)
    found = ok & inside(jj)
    u = np.where(found, jj + 1, np.searchsorted(start, p, side="right"))
    assert np.array_equal(u, np.searchsorted(start, p, side="right"))
    return u


def all_walk_model(rows, p0, lens, num_steps, rate, num_docs,
                   max_forward=8):
    """The kernel's all-mode walk over `rows` (TCS.walk_rows), lane by
    lane: up to N = 32 a warp holds floor(32 / N) MUMs, a lane a walker d;
    past it a warp holds one MUM, a lane the walkers d and d + 32.  Each
    walker steps as K10a's (is_head = p == its row's start, checked against
    searchsorted); a step's heads are the warp's ballots of `first`, and a
    head's height the lowest set bit above d of its MUM's mask, else N.
    Every (t, m, d) is written once.  Returns pos, height (T, M, N) int32
    and valid (T, M, N) bool."""
    start, head, dest = (rows[:, c].astype(np.int64) for c in (0, 2, 3))
    N = num_docs
    M = len(p0)
    W = 1 if N <= 32 else 2
    per_warp = 32 // N if W == 1 else 1
    warps = -(-M // per_warp)
    lane = np.tile(np.arange(32), warps)
    warp = np.repeat(np.arange(warps), 32)
    slot = lane // N if W == 1 else np.zeros_like(lane)
    base = slot * N
    m = warp * per_warp + slot
    mum = (slot < per_warp) & (m < M)
    # walkers (warp lane, walker k of the lane)
    d = np.stack([lane - base if W == 1 else lane + 32 * k
                  for k in range(W)])
    inn = mum[None, :] & (d < N)
    mm = np.where(mum, m, 0)
    p = np.where(inn, _wrap(np.asarray(p0, np.int64)[mm][None, :] + d), 0)
    u = np.where(inn, np.searchsorted(start, p, side="right"), 0)
    ln = np.where(mum, np.asarray(lens, np.int64)[mm], 0)
    sep = np.zeros_like(inn)
    pos = np.full((num_steps, M, N), -7, np.int64)
    height = np.full((num_steps, M, N), -7, np.int64)
    valid = np.zeros((num_steps, M, N), bool)
    written = np.zeros((num_steps, M, N), np.int64)
    for t in range(num_steps):
        act = inn & (t < ln)[None, :]
        j = np.maximum(u - 1, 0)
        is_head = p == start[j]
        assert np.array_equal(
            is_head[act],
            (p == start[np.clip(np.searchsorted(start, p, side="right") - 1,
                                0, start.size - 1)])[act])
        sep |= act & is_head & (d > 0)
        p = np.where(act, _wrap(head[j] + _wrap(p - start[j])), p)
        if t + 1 < num_steps:
            moved = locate_model(rows, dest[j].ravel(), p.ravel(),
                                 max_forward).reshape(u.shape)
            u = np.where(act, moved, u)
        first = inn & (sep | (d == 0))
        # 32-bit ballots, a 64-bit mask: unsigned, as the kernel's
        ballot = np.zeros((W, warps), np.uint64)
        for k in range(W):
            np.add.at(ballot[k], warp,
                      first[k].astype(np.uint64) << lane.astype(np.uint64))
        if W == 1:
            heads = ((ballot[0][warp] >> base.astype(np.uint64))
                     & np.uint64((1 << N) - 1))
        else:
            heads = ballot[0][warp] | (ballot[1][warp] << np.uint64(32))
        for k in range(W):
            sel = inn[k]
            dk = d[k][sel]
            below = np.array([(2 << int(x)) - 1 for x in dk], np.uint64)
            above = heads[sel] & ~below
            low = above & (~above + np.uint64(1))
            nxt_head = np.where(above != 0,
                                np.log2(np.maximum(low, 1)).astype(np.int64),
                                N)
            pos[t, m[sel], dk] = p[k][sel]
            height[t, m[sel], dk] = nxt_head - dk
            valid[t, m[sel], dk] = first[k][sel] & (t < ln[sel]) & (
                t % rate == 0)
            written[t, m[sel], dk] += 1
    assert (written == 1).all()
    return pos.astype(np.int32), height.astype(np.int32), valid


# N = 1, 2, 3, 4, 31, 32, 33, 64: a MUM a lane, MUMs of a warp not a power
# of two (lanes left over), one MUM filling the warp, two walkers a lane;
# rates 1 and 10, the binary search forced (max_forward 0)
ALL_WALK_MODEL_CASES = [(1, 1, 8), (2, 10, 8), (3, 1, 8), (4, 10, 8),
                        (31, 10, 8), (32, 1, 8), (33, 10, 8), (64, 1, 8),
                        (5, 3, 0), (48, 10, 1)]


@pytest.mark.parametrize("num_docs,rate,max_forward", ALL_WALK_MODEL_CASES)
def test_all_walk_model_matches_plain_and_jax(rng, num_docs, rate,
                                              max_forward):
    """K10b's walk as the kernel lays it out on a warp, on a random
    collection's FL table with random starts and the walk's edges (the
    last run, within N - 1 of n, past n, negative, near 2**31), lengths
    past T among them: equal to the plain version and JAX's _all_walk."""
    fl, ml, mp = _collection(rng, 4, 300, 6)
    n = int(fl.n)
    p0 = _edge_starts(fl, rng.integers(0, n, 40), num_docs, rng)
    lens = rng.integers(0, 30, p0.size).astype(np.int32)
    lens[:3] = (0, 1, 200)  # no step, one step, past every step
    T = 24
    fd = TCS.fl_tensors(fl, "cpu")
    got = all_walk_model(fd["rows"].numpy(), p0, lens, T, rate, num_docs,
                         max_forward)
    want = TCS.all_walk_ref(fd, torch.from_numpy(p0), torch.from_numpy(lens),
                            T, rate, num_docs)
    _assert_same(got, [x.numpy() for x in want])
    jax_want = CS._all_walk(CS.fl_device_arrays(fl), jnp.asarray(p0),
                            jnp.asarray(lens), T, rate, num_docs)
    _assert_same(got, jax_want)
    if num_docs > 1:
        assert (got[1][got[2]] < num_docs).any()  # fragments did split
