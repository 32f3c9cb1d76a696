"""Positional-automaton engine: the PyTorch port against the JAX package.

Both packages get the same index arrays and the same reads, made from a
seed with numpy; the port runs its plain PyTorch path on the CPU.  Every
compared value is an integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_pos as JQ
from colbwt_tpu_torch.models.tensors import (pos_tables_from_numpy,
                                             pos_tables_to_numpy)
from colbwt_tpu_torch.ops import query_pos as TQ
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads
from tests.test_torch_kernels import T1_CASES, t1_case_docs

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0x70C4)
    base = bytes(rng.choice(list(b"ACGT"), 240).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, index = build_index(docs)
    reads = make_reads(rng, docs, 20) + [
        b"NNNNN", b"A", docs[0][10:40] + b"N" + docs[0][40:90]]
    return tbl, index, docs, reads


@pytest.fixture(scope="module")
def jax_tables(case):
    """JAX-built tables, keyed by (alphabet, k)."""
    _, index, _, _ = case
    out = {}
    for alpha in (None, b"ACGT"):
        for k in (1, 2, 3, 4):
            if alpha is None and k == 4:
                continue
            out[alpha, k] = JQ.build_pos_tables(index, k, alphabet=alpha)
    return out


def t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def test_host_helpers_match_jax(case):
    _, index, _, reads = case
    for budget in (8, 40 * index.n, 300 * index.n * 8, 10 << 30):
        for alpha in (None, b"ACGT"):
            assert TQ.choose_k(index, budget, alpha) == \
                JQ.choose_k(index, budget, alpha)
    pt = TQ.build_pos_tables(index, 2, alphabet=b"ACGT", device=CPU)
    jpt = JQ.build_pos_tables(index, 2, alphabet=b"ACGT")
    for got, want in zip(TQ._encode_digits(index, pt, reads, 96),
                         JQ._encode_digits(index, jpt, reads, 96)):
        np.testing.assert_array_equal(got, want)
    dig = JQ._encode_digits(index, jpt, reads, 96)[0]
    for A in (4, 6, 17):
        for got, want in zip(TQ.pack_digits(dig, A), JQ.pack_digits(dig, A)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C", [None, 64, 37])
def test_t1_matches_jax(case, jax_tables, C):
    """Whole T1 built C positions per chunk (tail chunk overlapping) equals
    the JAX package's one-chunk T1."""
    _, index, _, _ = case
    kw = {} if C is None else {"t1_chunk": C}
    for alpha in (None, b"ACGT"):
        pt = TQ.build_pos_tables(index, 1, alphabet=alpha, device=CPU, **kw)
        want = jax_tables[alpha, 1]
        np.testing.assert_array_equal(pt["table"].numpy(),
                                      np.asarray(want["table"]))
        if alpha is not None:
            np.testing.assert_array_equal(pt["t1"].numpy(),
                                          np.asarray(want["t1"]))


def test_t1_tail_chunk_matches_jax(case):
    """One chunk at s = n - C of the JAX program vs the plain version."""
    _, index, _, _ = case
    n, C, c = index.n, 37, 2
    s = n - C
    a = TQ.t1_inputs(index, C, CPU)
    pred, succ = index.pred_jump[c], index.succ_jump[c]
    want = JQ._build_t1_chunk(
        jnp.zeros((2 * n, 2), jnp.int32), jnp.asarray(a["char"].numpy()),
        jnp.asarray(a["idx_pad"].numpy()), jnp.asarray(a["length"].numpy()),
        jnp.asarray(a["lf_pos0"].numpy()),
        jnp.asarray(a["threshold"].numpy()), jnp.asarray(pred),
        jnp.asarray(succ), jnp.asarray(a["col_id"].numpy()), jnp.int32(c),
        jnp.int32(n + s), jnp.int32(s), n=n, C=C)
    got = TQ.build_t1_chunk(torch.zeros((2 * n, 2), dtype=torch.int32),
                            a["char"], a["idx_pad"], a["length"],
                            a["lf_pos0"], a["threshold"], t(pred, np.int32),
                            t(succ, np.int32), a["col_id"], c, n + s, s, n, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def t1_case_index(name: str):
    docs, ff, _ = T1_CASES[name]
    tbl, index = build_index(t1_case_docs(docs))
    if ff is not None:
        index = index.build(tbl, ff_bound=ff)
    return index


@pytest.mark.parametrize("name", sorted(T1_CASES))
def test_t1_chunk_edge_cases_match_jax(name):
    """K1's plain version against JAX's _build_t1_chunk for every char, at
    the first chunk and the tail chunk s = n - C (which overlaps the one
    before it): every run of length 1 (ff_bound 1: r = n), a run longer
    than 4,096 positions, n below 1,024 positions, C not a multiple of
    1,024."""
    index = t1_case_index(name)
    n = index.n
    if name == "runs of length 1":
        assert index.r == n and index.ff_bound == 1
    elif name == "long run":
        assert int(index.length.max()) > 4096
    elif name == "n below the tile":
        assert n < 1024
    for C in T1_CASES[name][2]:
        C = n if C is None else C
        assert C <= n and (C == n or C % 1024)
        a = TQ.t1_inputs(index, C, CPU)
        arrays = [jnp.asarray(a[key].numpy()) for key in (
            "char", "idx_pad", "length", "lf_pos0", "threshold")]
        for c in range(index.sigma + 1):
            pred, succ = index.pred_jump[c], index.succ_jump[c]
            for s in sorted({0, n - C}):
                want = JQ._build_t1_chunk(
                    jnp.zeros((n, 2), jnp.int32), *arrays, jnp.asarray(pred),
                    jnp.asarray(succ), jnp.asarray(a["col_id"].numpy()),
                    jnp.int32(c), jnp.int32(s), jnp.int32(s), n=n, C=C)
                got = TQ.build_t1_chunk(
                    torch.zeros((n, 2), dtype=torch.int32), a["char"],
                    a["idx_pad"], a["length"], a["lf_pos0"], a["threshold"],
                    t(pred, np.int32), t(succ, np.int32), a["col_id"], c, s,
                    s, n, C)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"c={c} s={s} C={C}")


@pytest.mark.parametrize("s,C", [(0, None), (5, 37), (-64, 64), (0, 1)])
def test_t1_bytes_counts_what_the_chunk_reads(case, s, C):
    """chip_smoke.py's K1 byte bound against a walk of the chunk's
    positions: each array element a position's run reads (its fields, and
    the clamped successor's and predecessor's where the run does not
    match c) counted once, and 8 bytes a row written; s < 0 counts from
    n."""
    from chip_smoke import t1_bytes

    _, index, _, _ = case
    n, r = index.n, index.r
    C = n if C is None else C
    s = s % n
    idx = np.asarray(index.idx, np.int64)
    for c in range(index.sigma + 1):
        read = set()
        for pos in range(s, s + C):
            run = int(np.searchsorted(idx, pos, side="right")) - 1
            read |= {(name, run) for name in ("idx", "char", "pred", "succ",
                                              "col_id", "lf_pos0")}
            if index.char[run] == c:
                continue
            si = int(index.succ_jump[c][run])
            pi = int(index.pred_jump[c][run])
            if si < r:
                read |= {("threshold", min(si, r - 1)),
                         ("lf_pos0", min(si, r - 1))}
            if pi >= 0:
                read |= {("length", pi), ("lf_pos0", pi)}
        assert t1_bytes(index, c, s, C) == 4 * len(read) + 8 * C, c


@pytest.mark.parametrize("ka,kb", [(1, 1), (2, 1), (2, 2)])
def test_compose_matches_jax(case, jax_tables, ka, kb):
    _, index, _, _ = case
    n, A = index.n, 4
    ta = jax_tables[b"ACGT", ka]["table"]
    tb = jax_tables[b"ACGT", kb]["table"]
    buf = jnp.zeros((A ** (ka + kb) * n, 2), jnp.int32)
    want = JQ._compose_tables(buf, ta, tb, n=n, A=A, ka=ka, kb=kb)
    got = TQ.compose_tables(t(ta), t(tb), n, A, ka, kb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alpha,k", [(None, 2), (None, 3), (b"ACGT", 3),
                                     (b"ACGT", 4)])
def test_build_pos_tables_matches_jax(case, jax_tables, alpha, k):
    _, index, _, _ = case
    pt = TQ.build_pos_tables(index, k, alphabet=alpha, device=CPU)
    want = jax_tables[alpha, k]
    np.testing.assert_array_equal(pt["table"].numpy(),
                                  np.asarray(want["table"]))
    np.testing.assert_array_equal(pt["digit_of_dense"],
                                  want["digit_of_dense"])
    assert (pt["t1"] is None) == (want["t1"] is None)
    assert (pt["k"], pt["A"], pt["A_full"], pt["n"]) == \
        (want["k"], want["A"], want["A_full"], int(want["n"]))


# (alphabet, k, pack, masked, fresh_state, packed_out, M): each setting at
# least once, not the full product, so the JAX compiles stay few
SCANS = [
    (None, 1, 0, False, True, False, 32),
    (b"ACGT", 2, 2, False, True, True, 32),
    (None, 3, 4, True, False, False, 36),
    (b"ACGT", 4, 2, True, False, True, 32),
    (b"ACGT", 2, 0, False, True, True, 252),
    (b"ACGT", 2, 2, False, True, True, 256),
    (b"ACGT", 4, 0, False, True, False, 256),
]


@pytest.mark.parametrize("alpha,k,pack,masked,fresh,packed_out,M", SCANS)
def test_query_chunk_pos_matches_jax(case, jax_tables, alpha, k, pack, masked,
                                     fresh, packed_out, M):
    """JAX tables fed into the port's scan (pos_tables_from_numpy)."""
    _, index, _, reads = case
    jpt = jax_tables[alpha, k]
    pt = pos_tables_from_numpy(jpt, CPU)
    dig, lens, _ = JQ._encode_digits(index, jpt, [r[:M] for r in reads], M)
    B = dig.shape[0]
    rng = np.random.default_rng(M * 10 + k)
    if fresh:
        pos0 = np.full(B, index.n - 1, np.int32)
        mlen0 = np.zeros(B, np.int32)
        step_offset = 0
    else:
        pos0 = rng.integers(0, index.n, B).astype(np.int32)
        mlen0 = rng.integers(0, 300, B).astype(np.int32)
        step_offset = 2 * k
    (wp, wc), (wpos, wml) = JQ.query_chunk_pos(
        jpt["table"], jpt["n"], jnp.asarray(dig), jnp.asarray(lens),
        jnp.asarray(pos0), jnp.asarray(mlen0), jnp.int32(step_offset), k=k,
        A=jpt["A"], masked=masked, packed_out=packed_out, fresh_state=fresh)
    pat = TQ.pack_digits(dig, 4 if pack == 2 else 16)[0] if pack else dig
    (gp, gc), (gpos, gml) = TQ.query_chunk_pos(
        pt["table"], pt["n"], t(pat), t(lens), t(pos0), t(mlen0), step_offset,
        k, pt["A"], masked=masked, packed_out=packed_out, fresh_state=fresh,
        pack=pack)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert gp.numpy().dtype == np.asarray(wp).dtype
    if packed_out:
        assert gc is None and wc is None
    else:
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(gml.numpy(), np.asarray(wml))


@pytest.mark.parametrize("keep_t1", [True, False])
def test_query_batch_and_long_reads_match_jax(case, jax_tables, keep_t1):
    """ACGT keys with N-containing reads: the general-T1 fallback when it is
    kept, the compact engine when it is not."""
    tbl, index, docs, reads = case
    reads = reads + [docs[1][0:100] + b"N" + docs[1][100:200],
                     docs[2][5:205]]
    jpt = dict(jax_tables[b"ACGT", 3])
    pt = TQ.build_pos_tables(index, 3, alphabet=b"ACGT", device=CPU)
    if not keep_t1:
        jpt["t1"] = None
        pt["t1"] = None
    for fn_j, fn_t, kw in ((JQ.query_batch, TQ.query_batch, {}),
                           (JQ.query_long_reads, TQ.query_long_reads,
                            {"chunk": 48})):
        wp, wc = fn_j(index, reads, pt=jpt, **kw)
        gp, gc = fn_t(index, reads, pt=pt, **kw)
        for read, a, b, c, d in zip(reads, gp, wp, gc, wc):
            np.testing.assert_array_equal(a, b, err_msg=repr(read))
            np.testing.assert_array_equal(c, d, err_msg=repr(read))
    for read, p, c in zip(reads, gp, gc):
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(p, ep)
        np.testing.assert_array_equal(c, ec)


def test_port_tables_feed_the_jax_scan(case):
    """pos_tables_to_numpy(port tables) through the JAX package's
    query_batch equals the port's own query_batch."""
    _, index, _, reads = case
    pt = TQ.build_pos_tables(index, 2, alphabet=b"ACGT", device=CPU)
    wp, wc = JQ.query_batch(index, reads, pt=pos_tables_to_numpy(pt))
    gp, gc = TQ.query_batch(index, reads, pt=pt)
    for a, b in zip(gp, wp):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(gc, wc):
        np.testing.assert_array_equal(a, b)


def test_scan_rejects_non_digit_patterns(case):
    _, index, _, _ = case
    pt = TQ.build_pos_tables(index, 1, device=CPU)
    with pytest.raises(ValueError, match="uint8"):
        TQ.query_batch_pos(pt["table"], pt["n"],
                           torch.zeros((2, 4), dtype=torch.int32),
                           torch.full((2,), 4, dtype=torch.int32), 1, pt["A"])
