"""Wide mega engine (n >= 2**31): the PyTorch port against the JAX package
and the int64 oracle.

The index is the JAX wide tests' (tests/test_query_wide.py:33-42): a move
table whose run lengths are scaled by S = 2**23, so n is about 6.3e9 while
r stays small; the oracle runs the scaled table in int64.  The port runs
its plain PyTorch path on the CPU, and JAX's tables are fed into the port's
scan (and the port's into JAX's).  Every compared value is an integer, so
every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.models.index import MAX_WIDE_RUN_LEN, ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_mega_wide as JW
from colbwt_tpu_torch.models.tensors import (index_tensors,
                                             mega_table_from_numpy,
                                             mega_table_to_numpy, to_device)
from colbwt_tpu_torch.ops import query_mega as TM
from colbwt_tpu_torch.ops import query_mega_wide as TW
from tests.conftest import random_docs
from tests.test_query_wide import SCALE, scale_table
from tests.test_query_xla import build_index, make_reads

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def wide_setup():
    rng = np.random.default_rng(0xB16)
    base = bytes(rng.choice(list(b"ACGT"), 250).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    big = scale_table(tbl, SCALE)
    assert big.n > 2**31
    index = ColPmlIndex.build(big, ff_bound=2)
    assert index.wide
    reads = make_reads(rng, docs, 16) + [
        b"NNNNN", b"A", b"XYACGT", docs[0][:200], docs[1] + docs[2][:80]]
    return tbl, big, index, docs, reads


@pytest.fixture(scope="module")
def jax_tables(wide_setup):
    _, _, index, _, _ = wide_setup
    return {c: JW.build_mega_table_wide(index, compact=c)
            for c in (False, True)}


def _meta_equal(got, want):
    for key in ("n_lo", "n_hi", "pos0_lo", "pos0_hi", "r", "last_len"):
        assert got[key] == int(want[key]), key
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))


def test_full_table_matches_jax_and_host_rows(wide_setup, jax_tables):
    """The plain K6b full table equals JAX's device build and its host
    rows (searchsorted, not the bounded fast-forward)."""
    _, _, index, _, _ = wide_setup
    got = TW.build_mega_table_wide(index, compact=False, device=CPU)
    assert set(got) == set(jax_tables[False])
    np.testing.assert_array_equal(got["mega"].numpy(),
                                  JW.build_mega_rows_wide_host(index))
    np.testing.assert_array_equal(got["mega"].numpy(),
                                  np.asarray(jax_tables[False]["mega"]))
    _meta_equal(got, jax_tables[False])


def test_compact_tables_match_jax(wide_setup, jax_tables):
    _, _, index, _, _ = wide_setup
    got = TW.build_mega_table_wide(index, compact=True, device=CPU)
    want = jax_tables[True]
    assert set(got) == set(want)
    for key in ("shared", "percha"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    _meta_equal(got, want)


@pytest.mark.parametrize("ff", [2, 3])
def test_jump_rows_equal_the_recomputed_runs(wide_setup, ff):
    """The K6b kernel reads the index's succ_jump[c] / pred_jump[c] rows
    where JAX (and the plain version) recompute them with a reverse cummin
    and a cummax over the char array: the two agree for every char block,
    the all-sentinel block c = sigma included."""
    _, big, _, _, _ = wide_setup
    index = ColPmlIndex.build(big, ff_bound=ff)
    a = TW.run_arrays(index, CPU)
    r = index.r
    rows = torch.arange(r, dtype=torch.int32)
    for c in range(index.sigma + 1):
        is_c = a["char"] == c
        s_run = torch.flip(torch.cummin(torch.flip(
            torch.where(is_c, rows, r), [0]), 0).values, [0])
        p_run = torch.cummax(torch.where(is_c, rows, -1), 0).values
        np.testing.assert_array_equal(s_run.numpy(), index.succ_jump[c])
        np.testing.assert_array_equal(p_run.numpy(), index.pred_jump[c])


# (compact, masked, packed_out, fresh_state, M), each setting once; a
# carried-state chunk follows a 64-column masked first chunk (step_offset 64)
SCANS = [
    (False, False, True, True, 255),
    (False, True, False, False, 64),
    (True, False, False, True, 64),
    (True, True, True, False, 300),
]


@pytest.mark.parametrize("compact,masked,packed_out,fresh,M", SCANS)
def test_query_chunk_mega_wide_matches_jax(wide_setup, jax_tables, compact,
                                           masked, packed_out, fresh, M):
    """JAX tables fed into the port's scan; outputs (pad columns included)
    and the final limb state are compared."""
    _, _, index, _, reads = wide_setup
    jmt = jax_tables[compact]
    mt = mega_table_from_numpy(jmt, CPU)
    first = 0 if fresh else 64
    enc, lens = index.encode_patterns([r[:M + first] for r in reads],
                                      M + first)
    state = JW.initial_state_wide(jmt, enc.shape[0])
    if not fresh:
        _, state = JW.query_chunk_mega_wide(
            jmt, jnp.asarray(enc[:, M:].astype(np.uint8)),
            jnp.asarray(lens), state, jnp.int32(0), ff_bound=index.ff_bound)
    cols = enc[:, :M].astype(np.uint8)
    (wp, wc), wstate = JW.query_chunk_mega_wide(
        jmt, jnp.asarray(cols), jnp.asarray(lens), state, jnp.int32(first),
        ff_bound=index.ff_bound, masked=masked, packed_out=packed_out,
        fresh_state=fresh)
    (gp, gc), gstate = TW.query_chunk_mega_wide(
        mt, to_device(cols, CPU, np.uint8), to_device(lens, CPU),
        tuple(to_device(np.asarray(s), CPU) for s in state), first,
        ff_bound=index.ff_bound, masked=masked, packed_out=packed_out,
        fresh_state=fresh)
    assert gp.numpy().dtype == np.asarray(wp).dtype
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if packed_out:
        assert gc is None and wc is None
    else:
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert len(gstate) == 5
    for g, w in zip(gstate, wstate):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# the dispatch scan's output modes -> (packed_out, M): the uint16 plane (M
# <= 255), the packed int32 plane (M > 255) and two int32 planes
BATCH_MODES = {"u16": (True, 255), "i32": (True, 300), "planes": (False, 255)}


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
@pytest.mark.parametrize("mode", list(BATCH_MODES))
def test_batch_plane_equals_jax_masked_scan(wide_setup, jax_tables, compact,
                                            mode):
    """The port's dispatch scan is masked: its plane, pad columns included,
    equals JAX's query_chunk_mega_wide(..., masked=True,
    fresh_state=True) on the same reads, in both layouts."""
    _, _, index, _, reads = wide_setup
    jmt = jax_tables[compact]
    packed_out, M = BATCH_MODES[mode]
    enc, lens = index.encode_patterns([r[:M] for r in reads], M)
    cols = enc.astype(np.uint8)
    (wp, wc), _ = JW.query_chunk_mega_wide(
        jmt, jnp.asarray(cols), jnp.asarray(lens),
        JW.initial_state_wide(jmt, enc.shape[0]), jnp.int32(0),
        ff_bound=index.ff_bound, masked=True, packed_out=packed_out,
        fresh_state=True)
    gp, gc = TW.query_batch_mega_wide(
        mega_table_from_numpy(jmt, CPU), to_device(cols, CPU, np.uint8),
        to_device(lens, CPU), ff_bound=index.ff_bound, packed_out=packed_out)
    assert gp.numpy().dtype == np.asarray(wp).dtype
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if packed_out:
        assert gc is None and wc is None
    else:
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    pad = np.arange(M)[None, :] < M - lens[:, None]
    assert pad.any() and not gp.numpy()[pad].any()


@pytest.mark.parametrize("compact", [False, True])
def test_query_batch_matches_int64_oracle(wide_setup, compact):
    _, big, index, _, reads = wide_setup
    mt = TW.build_mega_table_wide(index, compact=compact, device=CPU)
    pmls, cids = TW.query_batch(index, reads, mt=mt)
    for read, pml, cid in zip(reads, pmls, cids):
        ep, ec = O.query_pml_oracle(big, read)
        np.testing.assert_array_equal(pml, ep, err_msg=f"PML {read!r}")
        np.testing.assert_array_equal(cid, ec, err_msg=f"CID {read!r}")


@pytest.mark.parametrize("compact", [False, True])
def test_long_reads_equal_single_scan(wide_setup, compact):
    rng = np.random.default_rng(7)
    _, _, index, docs, _ = wide_setup
    reads = [docs[0] * 3, docs[1][:100], bytes(
        rng.choice(list(b"ACGTN"), 500).astype("uint8"))]
    mt = TW.build_mega_table_wide(index, compact=compact, device=CPU)
    p1, c1 = TW.query_batch(index, reads, mt=mt)
    p2, c2 = TW.query_long_reads(index, reads, chunk=64, mt=mt)
    for a, b, c, d in zip(p1, p2, c1, c2):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)


def test_port_tables_feed_the_jax_scan(wide_setup):
    _, _, index, _, reads = wide_setup
    mt = TW.build_mega_table_wide(index, compact=False, device=CPU)
    wp, wc = JW.query_batch(index, reads, mt=mega_table_to_numpy(mt))
    gp, gc = TW.query_batch(index, reads, mt=mt)
    for a, b, c, d in zip(gp, wp, gc, wc):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)


def test_compact_auto_selection(wide_setup):
    _, _, index, _, _ = wide_setup
    full = TW.wide_table_bytes(index, compact=False)
    assert full == JW.wide_table_bytes(index, compact=False)
    assert TW.wide_table_bytes(index, compact=True) == \
        JW.wide_table_bytes(index, compact=True) < full
    mt = TW.build_mega_table_wide(index, hbm_budget_bytes=full, device=CPU)
    assert "mega" in mt and "shared" not in mt
    mt = TW.build_mega_table_wide(index, hbm_budget_bytes=full - 1,
                                  device=CPU)
    assert "shared" in mt and "percha" in mt and "mega" not in mt


def test_wide_engine_on_narrow_index_matches_narrow():
    """The limb engine is exact on ordinary tables too (hi limb 0)."""
    rng = np.random.default_rng(0xA11)
    base = bytes(rng.choice(list(b"ACGT"), 200).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    assert not index.wide
    reads = make_reads(rng, docs, 16)
    p1, c1 = TM.query_batch(index, reads, device=CPU)
    p2, c2 = TW.query_batch(index, reads, device=CPU)
    for a, b, c, d in zip(p1, p2, c1, c2):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)


@pytest.mark.parametrize("what,match", [
    ("cid", "col ids"), ("run", "2\\*\\*29"), ("unsplit", "run-split")])
def test_refusals(wide_setup, what, match):
    tbl, _, index, _, _ = wide_setup
    if what == "unsplit":
        index = ColPmlIndex.from_table(tbl, wide=True)
    else:
        field = "col_id" if what == "cid" else "length"
        arr = getattr(index, field).copy()
        arr[0] = 300 if what == "cid" else MAX_WIDE_RUN_LEN + 1
        index = ColPmlIndex(**{**index.__dict__, field: arr})
    with pytest.raises(ValueError, match=match):
        TW.build_mega_table_wide(index, device=CPU)


def test_compact_engine_refuses_wide_index(wide_setup):
    _, _, index, _, _ = wide_setup
    with pytest.raises(ValueError, match="query_mega_wide"):
        index_tensors(index, CPU)
