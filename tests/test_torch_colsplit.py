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
