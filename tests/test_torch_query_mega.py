"""Mega engine: the PyTorch port against the JAX package.

Both packages get the same index arrays and the same reads, made from a
seed with numpy; the port runs its plain PyTorch path on the CPU, and JAX's
tables are fed into the port's scan (and the port's into JAX's).  Every
compared value is an integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_mega as JM
from colbwt_tpu_torch.models.tensors import (mega_table_from_numpy,
                                             mega_table_to_numpy, to_device)
from colbwt_tpu_torch.ops import query_mega as TM
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    """Indexes split at ff_bound 2 and 3 (the second records a bound > 2,
    so the scan takes extra fast-forward rounds through the length array),
    and reads up to 350 characters, with N and absent bytes."""
    rng = np.random.default_rng(0x3E6A)
    base = bytes(rng.choice(list(b"ACGT"), 250).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, unsplit = build_index(docs)
    indexes = {f: ColPmlIndex.build(tbl, ff_bound=f) for f in (2, 3)}
    assert indexes[2].ff_bound >= 2 and indexes[3].ff_bound > 2
    reads = make_reads(rng, docs, 20) + [
        b"NNNNN", b"A", b"XYACGT", docs[0][:240], docs[1][10:250] + b"N",
        docs[2] + docs[0][:100]]
    return tbl, unsplit, indexes, docs, reads


@pytest.fixture(scope="module")
def jax_tables(case):
    _, _, indexes, _, _ = case
    return {f: JM.build_mega_table(index) for f, index in indexes.items()}


@pytest.mark.parametrize("ff", [2, 3])
def test_build_mega_table_matches_jax(case, jax_tables, ff):
    _, _, indexes, _, _ = case
    got = TM.build_mega_table(indexes[ff], device=CPU)
    want = jax_tables[ff]
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mega"].numpy(),
                                  np.asarray(want["mega"]))
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))
    for key in ("n", "r", "last_len"):
        assert got[key] == int(want[key]), key


def _state_np(state):
    return [np.asarray(s) for s in state]


# (ff, masked, packed_out, fresh_state, M): each setting at least once, not
# the product, so the JAX compiles stay few.  A carried-state chunk follows
# a 64-column masked first chunk of the same reads (step_offset 64).
SCANS = [
    (2, False, False, True, 64),
    (2, False, True, True, 255),
    (2, True, True, False, 300),
    (3, True, False, False, 64),
    (3, False, True, True, 300),
]


@pytest.mark.parametrize("ff,masked,packed_out,fresh,M", SCANS)
def test_query_chunk_mega_matches_jax(case, jax_tables, ff, masked,
                                      packed_out, fresh, M):
    """JAX tables fed into the port's scan (mega_table_from_numpy); the
    outputs, pad columns included, and the final state are compared."""
    _, _, indexes, _, reads = case
    index = indexes[ff]
    jmt = jax_tables[ff]
    mt = mega_table_from_numpy(jmt, CPU)
    first = 0 if fresh else 64
    enc, lens = index.encode_patterns([r[:M + first] for r in reads],
                                      M + first)
    B = enc.shape[0]
    state = JM.initial_state(jmt, B)
    if not fresh:  # carried state: the JAX scan of the rightmost chunk
        _, state = JM.query_chunk_mega(
            jmt, jnp.asarray(enc[:, M:].astype(np.uint8)),
            jnp.asarray(lens), state, jnp.int32(0), ff_bound=index.ff_bound)
    cols = enc[:, :M].astype(np.uint8)
    (wp, wc), wstate = JM.query_chunk_mega(
        jmt, jnp.asarray(cols), jnp.asarray(lens), state, jnp.int32(first),
        ff_bound=index.ff_bound, masked=masked, packed_out=packed_out,
        fresh_state=fresh)
    (gp, gc), gstate = TM.query_chunk_mega(
        mt, to_device(cols, CPU, np.uint8), to_device(lens, CPU),
        tuple(to_device(s, CPU) for s in _state_np(state)), first,
        ff_bound=index.ff_bound, masked=masked, packed_out=packed_out,
        fresh_state=fresh)
    assert gp.numpy().dtype == np.asarray(wp).dtype
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if packed_out:
        assert gc is None and wc is None
    else:
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    for g, w in zip(gstate, _state_np(wstate)):
        np.testing.assert_array_equal(g.numpy(), w)


# the dispatch scan's output modes -> (packed_out, M): the uint16 plane (M
# <= 255), the packed int32 plane (M > 255) and two int32 planes
BATCH_MODES = {"u16": (True, 255), "i32": (True, 300), "planes": (False, 255)}


@pytest.mark.parametrize("mode", list(BATCH_MODES))
def test_batch_plane_equals_jax_masked_scan(case, jax_tables, mode):
    """The port's dispatch scan is masked: its plane, pad columns included,
    equals JAX's query_chunk_mega(..., masked=True, fresh_state=True) on
    the same reads (JAX's own query_batch_mega is unmasked, so its pad
    columns differ; every real column is the same)."""
    _, _, indexes, _, reads = case
    index, jmt = indexes[2], jax_tables[2]
    packed_out, M = BATCH_MODES[mode]
    enc, lens = index.encode_patterns([r[:M] for r in reads], M)
    cols = enc.astype(np.uint8)
    (wp, wc), _ = JM.query_chunk_mega(
        jmt, jnp.asarray(cols), jnp.asarray(lens),
        JM.initial_state(jmt, enc.shape[0]), jnp.int32(0),
        ff_bound=index.ff_bound, masked=True, packed_out=packed_out,
        fresh_state=True)
    gp, gc = TM.query_batch_mega(
        mega_table_from_numpy(jmt, CPU), to_device(cols, CPU, np.uint8),
        to_device(lens, CPU), ff_bound=index.ff_bound, packed_out=packed_out)
    assert gp.numpy().dtype == np.asarray(wp).dtype
    assert gp.dtype == {"u16": torch.uint16, "i32": torch.int32,
                        "planes": torch.int32}[mode]
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if packed_out:
        assert gc is None and wc is None
    else:
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    pad = np.arange(M)[None, :] < M - lens[:, None]
    assert pad.any() and not gp.numpy()[pad].any()


@pytest.mark.parametrize("mode", ["tunnels", "all"])
def test_query_batch_matches_jax_and_oracle(mode):
    rng = np.random.default_rng(0x3E6B)
    base = bytes(rng.choice(list(b"ACGT"), 250).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs, mode=mode)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    reads = make_reads(rng, docs, 24) + [b"NNNNN", b"A", b"XYACGT"]
    wp, wc = JM.query_batch(index, reads)
    gp, gc = TM.query_batch(index, reads, device=CPU)
    for read, a, b, c, d in zip(reads, gp, wp, gc, wc):
        np.testing.assert_array_equal(a, b, err_msg=repr(read))
        np.testing.assert_array_equal(c, d, err_msg=repr(read))
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(a, ep, err_msg=repr(read))
        np.testing.assert_array_equal(c, ec, err_msg=repr(read))


def test_long_reads_equal_single_scan_and_jax(case, jax_tables):
    """Chunked carried-state scans (chunk 64) equal one scan of each whole
    read and the JAX package's chunked scans."""
    tbl, _, indexes, docs, reads = case
    index = indexes[3]
    mt = TM.build_mega_table(index, device=CPU)
    p1, c1 = TM.query_batch(index, reads, mt=mt)
    p2, c2 = TM.query_long_reads(index, reads, chunk=64, mt=mt)
    wp, wc = JM.query_long_reads(index, reads, chunk=64, mt=jax_tables[3])
    for read, a, b, c, d, e, f in zip(reads, p1, p2, wp, c1, c2, wc):
        np.testing.assert_array_equal(a, b, err_msg=repr(read))
        np.testing.assert_array_equal(b, c, err_msg=repr(read))
        np.testing.assert_array_equal(d, e, err_msg=repr(read))
        np.testing.assert_array_equal(e, f, err_msg=repr(read))
    ep, ec = O.query_pml_oracle(tbl, reads[-1])
    np.testing.assert_array_equal(p2[-1], ep)
    np.testing.assert_array_equal(c2[-1], ec)


def test_port_tables_feed_the_jax_scan(case):
    """mega_table_to_numpy(port table) through the JAX package's
    query_batch equals the port's own query_batch."""
    _, _, indexes, _, reads = case
    index = indexes[2]
    mt = TM.build_mega_table(index, device=CPU)
    wp, wc = JM.query_batch(index, reads, mt=mega_table_to_numpy(mt))
    gp, gc = TM.query_batch(index, reads, mt=mt)
    for a, b, c, d in zip(gp, wp, gc, wc):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)


def test_refusals(case):
    tbl, unsplit, _, _, _ = case
    with pytest.raises(ValueError, match="run-split"):
        TM.build_mega_table(unsplit, device=CPU)
    wide = ColPmlIndex.build(tbl, ff_bound=2, wide=True)
    with pytest.raises(ValueError, match="query_mega_wide"):
        TM.build_mega_table(wide, device=CPU)


def test_scan_rejects_int32_patterns(case):
    _, _, indexes, _, _ = case
    mt = TM.build_mega_table(indexes[2], device=CPU)
    with pytest.raises(ValueError, match="uint8"):
        TM.query_batch_mega(mt, torch.zeros((2, 4), dtype=torch.int32),
                            torch.full((2,), 4, dtype=torch.int32))


def test_default_device_raises_without_cuda(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, indexes, _, reads = case
    with pytest.raises(RuntimeError, match="is_available"):
        TM.query_batch(indexes[2], reads)
