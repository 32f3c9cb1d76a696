"""Fused engine: the PyTorch port against the JAX package.

Both packages get the same run-split index and the same reads, made from a
seed with numpy; the port runs its plain PyTorch path on the CPU.  Every
compared value is an integer, so every comparison is exact.  The kernel K7
against this plain version is in tests/test_torch_kernels.py (card only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_fused as JF
from colbwt_tpu.pipeline.engines import QueryEngines as JaxEngines
from colbwt_tpu.utils.config import ColBwtConfig
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.ops import query_fused as TF
from colbwt_tpu_torch.pipeline.engines import QueryEngines
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["tunnels", "all"])
def case(request):
    rng = np.random.default_rng(0xF05E if request.param == "tunnels"
                                else 0xF0A1)
    base = bytes(rng.choice(list(b"ACGT"), 260).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs, mode=request.param)
    # several lengths padded into one batch, reads with N, absent chars
    reads = (make_reads(rng, docs, 30, lo=5, hi=90)
             + [b"NNNNNNN", b"ACGTNACGT", b"XACGTX", b"A"])
    return tbl, {ff: ColPmlIndex.build(tbl, ff_bound=ff) for ff in (1, 2, 4)}, \
        reads


@pytest.mark.parametrize("ff", [1, 2, 4])
def test_fused_tables_match_jax(case, ff):
    """Every table equals JAX's, but for run_rows' column 6, which JAX
    leaves 0 and the port fills with the first fast-forward round's
    length, length[clip(dest_interval)]."""
    _, split, _ = case
    index = split[ff]
    got = TF.build_fused_tables(index, CPU)
    want = JF.build_fused_tables(index)
    assert set(got) == set(want)
    for name, arr in want.items():
        g = got[name]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(arr)
        if name == "run_rows":
            keep = [j for j in range(8) if j != 6]
            np.testing.assert_array_equal(g[:, keep], w[:, keep],
                                          err_msg=name)
            assert not w[:, 6].any()
            di = np.clip(w[:, 2], 0, index.r - 1)
            np.testing.assert_array_equal(g[:, 6], np.asarray(
                want["length"])[di], err_msg="run_rows[:, 6]")
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        if isinstance(got[name], torch.Tensor):
            assert got[name].dtype == torch.int32


@pytest.mark.parametrize("ff", [1, 2, 4])
def test_query_batch_fused_matches_jax(case, ff):
    """The plain scan against JAX's, pad columns included, at the index's
    recorded bound."""
    _, split, reads = case
    index = split[ff]
    assert index.ff_bound >= ff
    enc, lens = index.encode_patterns(reads, 96)
    wp, wc = JF.query_batch_fused(JF.build_fused_tables(index),
                                  jnp.asarray(enc), jnp.asarray(lens),
                                  ff_bound=index.ff_bound)
    before = dict(K.launches)
    gp, gc = TF.query_batch_fused(TF.build_fused_tables(index, CPU),
                                  to_device(enc, CPU), to_device(lens, CPU),
                                  ff_bound=index.ff_bound)
    assert dict(K.launches) == before  # the CPU takes the plain version
    assert gp.dtype == gc.dtype == torch.int32
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("ff", [1, 2, 4])
def test_query_batch_matches_oracle(case, ff):
    tbl, split, reads = case
    gp, gc = TF.query_batch(split[ff], reads, device=CPU)
    wp, wc = JF.query_batch(split[ff], reads)
    for read, p, c, a, b in zip(reads, gp, gc, wp, wc):
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(p, ep, err_msg=repr(read))
        np.testing.assert_array_equal(c, ec, err_msg=repr(read))
        np.testing.assert_array_equal(p, a)
        np.testing.assert_array_equal(c, b)


def test_query_batch_requires_split_index(case):
    tbl, _, _ = case
    unsplit = ColPmlIndex.from_table(tbl)
    with pytest.raises(ValueError, match="run-split"):
        TF.query_batch(unsplit, [b"ACGT"], device=CPU)


def test_wide_index_refused(case):
    tbl, _, _ = case
    with pytest.raises(ValueError, match="query_mega_wide"):
        TF.build_fused_tables(ColPmlIndex.build(tbl, ff_bound=2, wide=True),
                              CPU)


@pytest.mark.parametrize("engine,ff", [("auto", 1), ("fused", 2),
                                       ("fused", 4)])
def test_ladder_picks_fused(case, engine, ff):
    """The ladder's choice and the dispatched batch equal the JAX
    package's: `auto` on an ff_bound == 1 index (the mega engine needs 2)
    and `--engine fused` on any run-split index."""
    _, split, reads = case
    index = split[ff]
    cfg = ColBwtConfig(engine=engine)
    eng = QueryEngines(index, cfg, total_chars=10, device=CPU)
    jeng = JaxEngines(index, cfg, total_chars=10)
    assert eng.name == jeng.name == "fused"
    for padded in (64, 128):
        batch = [r for r in reads if len(r) <= padded]
        p, c, lens = QueryEngines.materialize(eng.dispatch(batch, padded))
        jp, jc, jl = JaxEngines.materialize(jeng.dispatch(batch, padded))
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(lens, jl)


def test_ladder_skips_fused_without_run_splitting(case):
    """An unsplit index (ff_bound 0) never gets the fused engine: the
    ladder falls to the compact engine, as in JAX."""
    tbl, _, _ = case
    unsplit = ColPmlIndex.from_table(tbl)
    cfg = ColBwtConfig(engine="fused")
    eng = QueryEngines(unsplit, cfg, total_chars=10, device=CPU)
    assert eng.name == JaxEngines(unsplit, cfg, total_chars=10).name == "xla"


@pytest.fixture(scope="module")
def fold_case():
    """One run-split index and reads for the folded fast-forward: mixed
    lengths, an empty read, N reads, bytes absent from the index and
    one-character reads.  Every read starts on the last run (r - 1), so its
    first step reads that run's row and folded length."""
    rng = np.random.default_rng(0xF01D)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 4, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=3)
    reads = (make_reads(rng, docs, 40, lo=2, hi=120)
             + [b"", b"N", b"A", b"C", b"G", b"T", b"NNNNACGT", b"ACGTNNA",
                b"XYZ", b"AC\x02GT", docs[-1][-100:], docs[0][:80]])
    return index, reads


@pytest.mark.parametrize("ff", [1, 2, 3, 4])
def test_folded_fast_forward_matches_jax(fold_case, ff):
    """The plain scan, whose first fast-forward round reads run_rows[:, 6],
    against JAX's query_batch_fused, whose round gathers `length`, at
    ff_bound 1 (no round), 2 (the folded round alone), 3 and 4 (the folded
    round, then gathered ones) on one index; pad columns included."""
    index, reads = fold_case
    enc, lens = index.encode_patterns(reads, 128)
    wp, wc = JF.query_batch_fused(JF.build_fused_tables(index),
                                  jnp.asarray(enc), jnp.asarray(lens),
                                  ff_bound=ff)
    ft = TF.build_fused_tables(index, CPU)
    for dtype in (np.int32, np.uint8):
        gp, gc = TF.query_batch_fused(ft, to_device(enc, CPU, dtype),
                                      to_device(lens, CPU), ff_bound=ff)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
