"""The sharded mega engines' two routes and the one-launch masked gather
(colbwt_tpu_torch/parallel/) against the JAX package, on the CPU.

A chunk of a dp row whose ip shards all sit on one device takes the chunk
scan `sharded_scan_mega` (here its plain version `sharded_scan_mega_ref`);
shards spread over devices take the per-step route `step_chunk`.  The JAX
engines run on the 8-device virtual CPU mesh (tests/conftest.py), the
port's on one-process meshes over ["cpu"] * 8, or over ["cpu", "cpu:0"]
(two device names, so two "cards" on the CPU), on the same index and
reads made from a numpy seed.  Every value is an integer, so every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from colbwt_tpu import parallel as JP
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.parallel import query_sharded_mega as JSM
from colbwt_tpu.parallel import query_sharded_mega_wide as JSW
from colbwt_tpu_torch import parallel as TP
from colbwt_tpu_torch.parallel import mesh as TMESH
from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW
from tests.conftest import random_docs
from tests.test_query_wide import scale_table
from tests.test_query_xla import build_index, make_reads


def tmesh(dp, ip, devices=None):
    return TP.make_mesh(dp, ip, devices=devices or ["cpu"] * 8)


def assert_same(got, want):
    (gp, gc), (wp, wc) = got, want
    assert len(gp) == len(gc) == len(wp)
    for j in range(len(wp)):
        np.testing.assert_array_equal(gp[j], wp[j], err_msg=f"pml {j}")
        np.testing.assert_array_equal(gc[j], wc[j], err_msg=f"cid {j}")


@pytest.fixture
def routes(monkeypatch):
    """Counts of the chunks each route of `scan_chunk` took."""
    seen = {"scan": 0, "step": 0}
    scan, step = TSM.sharded_scan_mega, TSM.step_chunk

    def spy_scan(*a, **kw):
        seen["scan"] += 1
        return scan(*a, **kw)

    def spy_step(*a, **kw):
        seen["step"] += 1
        return step(*a, **kw)

    monkeypatch.setattr(TSM, "sharded_scan_mega", spy_scan)
    monkeypatch.setattr(TSM, "step_chunk", spy_step)
    return seen


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(0x5CA7)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    # ragged against every dp; an empty read and an N read among them
    reads = make_reads(rng, docs, 17) + [b"", b"NNACGT"]
    return index, reads


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(0x5CA8)
    base = bytes(rng.choice(list(b"ACGT"), 250).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    big = scale_table(tbl, 2**23)
    index = ColPmlIndex.build(big, ff_bound=2)
    assert index.wide
    reads = make_reads(rng, docs, 21) + [b"", b"NNNNN", b"A"]
    return big, index, reads


# ---------------------------------------------------------------------------
# the chunk route at every layout of tests/test_parallel.py


@pytest.mark.parametrize("dp,ip", [(4, 2), (1, 8), (2, 2), (8, 1)])
def test_scan_route_mega_matches_jax(narrow, routes, dp, ip):
    """K13b's chunk scan (one chunk a dp row) equals JAX's
    _sharded_mega_query through query_batch_sharded_mega, empty reads and
    dp padding rows included."""
    index, reads = narrow
    got = TSM.query_batch_sharded_mega(index, reads, mesh=tmesh(dp, ip))
    assert routes == {"scan": dp, "step": 0}
    assert_same(got, JSM.query_batch_sharded_mega(index, reads,
                                                  mesh=JP.make_mesh(dp, ip)))


@pytest.mark.parametrize("dp,ip", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_scan_route_wide_matches_jax_and_oracle(wide, routes, dp, ip):
    """K13c's chunk scan equals JAX's _sharded_mega_wide_chunk through
    query_batch_sharded_mega_wide, and the oracle."""
    big, index, reads = wide
    got = TSW.query_batch_sharded_mega_wide(index, reads, mesh=tmesh(dp, ip))
    assert routes == {"scan": dp, "step": 0}
    assert_same(got, JSW.query_batch_sharded_mega_wide(
        index, reads, mesh=JP.make_mesh(dp, ip)))
    ref = [O.query_pml_oracle(big, r) for r in reads]
    assert_same(got, ([p for p, _ in ref], [c for _, c in ref]))


@pytest.mark.parametrize("dp,ip,chunk", [(4, 2, 64), (1, 8, 100),
                                         (2, 4, 64), (8, 1, 100)])
def test_long_reads_carry_state_over_chunks(wide, routes, dp, ip, chunk):
    """Long reads in 2-3 chunks from the right, the state carried from
    chunk to chunk in the chunk scan: equal to JAX's
    query_long_reads_sharded_mega_wide and to one scan of the whole read."""
    _, index, reads = wide
    rng = np.random.default_rng(dp * 10 + ip)
    long_reads = [bytes(rng.choice(list(b"ACGTN"), 190).astype("uint8")),
                  (reads[0] * 4)[:170], reads[1][:33], b""]
    n_chunks = -(-max(len(p) for p in long_reads) // chunk)
    assert n_chunks in (2, 3)
    got = TSW.query_long_reads_sharded_mega_wide(
        index, long_reads, mesh=tmesh(dp, ip), chunk=chunk)
    assert routes == {"scan": dp * n_chunks, "step": 0}
    assert_same(got, JSW.query_long_reads_sharded_mega_wide(
        index, long_reads, mesh=JP.make_mesh(dp, ip), chunk=chunk))
    assert_same(got, TSW.query_batch_sharded_mega_wide(
        index, long_reads, mesh=tmesh(dp, ip)))


@pytest.mark.parametrize("dp,ip", [(1, 5), (2, 4)])
def test_ip_not_dividing_rows(narrow, wide, routes, dp, ip):
    """ip divides neither mega table's rows: the last shard ends in zero
    padding rows; both engines still equal JAX's."""
    index, reads = narrow
    assert (index.sigma + 1) * index.r % ip
    assert_same(TSM.query_batch_sharded_mega(index, reads,
                                             mesh=tmesh(dp, ip)),
                JSM.query_batch_sharded_mega(index, reads,
                                             mesh=JP.make_mesh(dp, ip)))
    _, windex, wreads = wide
    assert (windex.sigma + 1) * windex.r % ip
    assert_same(TSW.query_batch_sharded_mega_wide(windex, wreads,
                                                  mesh=tmesh(dp, ip)),
                JSW.query_batch_sharded_mega_wide(windex, wreads,
                                                  mesh=JP.make_mesh(dp, ip)))
    assert routes == {"scan": 2 * dp, "step": 0}


def test_row_outside_every_shard_reads_zeros(wide):
    """Carried state whose rows c·r + interval fall below 0 or past every
    shard: the chunk scan reads those rows as zeros (not clamped into the
    table), as JAX's masked take summed over "ip"; outputs and final state
    equal JAX's _sharded_mega_wide_chunk on the same state."""
    _, index, reads = wide
    dp, ip = 2, 4
    rng = np.random.default_rng(0x0FF)
    enc, lens = index.encode_patterns(reads[:8], 64)
    B = enc.shape[0]
    tm = tmesh(dp, ip)
    tst = TSW.shard_mega_wide(index, tm)
    rows_padded = tst["rows_padded"]
    interval = rng.integers(0, index.r, B).astype(np.int32)
    interval[0::3] = rows_padded  # past every shard
    interval[1::3] = -7 - 10 * np.arange(len(interval[1::3]))  # below 0
    state = (interval,
             rng.integers(0, 50, B).astype(np.int32),
             rng.integers(0, 1 << 30, B).astype(np.int32),
             rng.integers(0, 4, B).astype(np.int32),
             rng.integers(0, 9, B).astype(np.int32))

    jm = JP.make_mesh(dp, ip)
    jst = JSW.shard_mega_wide(index, jm)
    (jp, jc), jfinal = JSW._sharded_mega_wide_chunk(
        jm, jst["mega"], jst["length"], enc, lens, state, np.int32(5),
        jst["rows_padded"] // ip, jst["n_lo"], jst["n_hi"], jst["r"],
        ff_bound=index.ff_bound)

    bl = B // dp
    for d in range(dp):
        sl = slice(d * bl, (d + 1) * bl)
        st_d = tuple(torch.from_numpy(a[sl].copy()) for a in state)
        p, c = TSM.scan_chunk(tm, tst, d,
                              torch.from_numpy(enc[sl].astype(np.uint8)),
                              torch.from_numpy(lens[sl]), st_d, 5,
                              index.ff_bound, True)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp)[sl])
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc)[sl])
        for t, j in zip(st_d, jfinal):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j)[sl])


# ---------------------------------------------------------------------------
# the plain one-launch fetch


@pytest.mark.parametrize("W,sel", [(2, False), (2, True), (8, False),
                                   (8, True), (16, False), (16, True)])
def test_multi_shard_fetch_is_the_sum_of_single_fetches(W, sel):
    """The plain fetch over a card's shards equals the sum of each shard's
    masked gather, with and without a selector and stride, lanes below 0
    and past the last shard reading 0, and a shard held by another card
    (None) contributing nothing; `out` is written and returned."""
    rng = np.random.default_rng(W * 2 + sel)
    ip, L, B, n_sel = 4, 37, 301, 3
    full = rng.integers(-2**31, 2**31 - 1, (n_sel, ip * L, W),
                        dtype=np.int64).astype(np.int32)
    shards = [torch.from_numpy(
        (full[:, i * L:(i + 1) * L] if sel else full[0, i * L:(i + 1) * L])
        .reshape(-1, W).copy()) for i in range(ip)]
    g = torch.from_numpy(rng.integers(-9, ip * L + 9, B).astype(np.int32))
    s = (torch.from_numpy(rng.integers(0, n_sel, B).astype(np.int32))
         if sel else None)
    stride = L if sel else 0
    got = TMESH.sharded_fetch(shards, g, s, L, stride)
    want = sum(TMESH._shard_fetch_ref(t, g, s, i * L, L, stride)
               for i, t in enumerate(shards))
    assert torch.equal(got, want)
    gl = g.long()
    ok = (gl >= 0) & (gl < ip * L)
    assert 0 < int(ok.sum()) < B
    direct = torch.from_numpy(full)[s.long() if sel else 0,
                                    gl.clamp(0, ip * L - 1)]
    assert torch.equal(got, torch.where(ok[:, None], direct, 0))
    # shard 2 on another card: its lanes read 0 here
    part = [t if i != 2 else None for i, t in enumerate(shards)]
    out = torch.full((B, W), 7, dtype=torch.int32)
    res = TMESH.sharded_fetch(part, g, s, L, stride, out=out)
    assert res is out
    mine = ok & ((gl < 2 * L) | (gl >= 3 * L))
    assert torch.equal(out, torch.where(mine[:, None], direct, 0))


# ---------------------------------------------------------------------------
# the route choice and the per-step route


@pytest.mark.parametrize("wide_engine", [False, True])
def test_route_follows_where_shards_lie(narrow, wide, routes, wide_engine):
    """A mesh whose row spans two device names ("cpu", "cpu:0": two cards
    as one process sees them) takes the per-step route, a fetch a card and
    an add a step; it equals JAX's engine and the one-device mesh's chunk
    scan."""
    if wide_engine:
        _, index, reads = wide
        run, jrun = (TSW.query_batch_sharded_mega_wide,
                     JSW.query_batch_sharded_mega_wide)
    else:
        index, reads = narrow
        run, jrun = (TSM.query_batch_sharded_mega,
                     JSM.query_batch_sharded_mega)
    two = tmesh(2, 2, devices=["cpu", "cpu:0"] * 2)
    assert len(two.card_shards(two.shard(lambda i, dev: i), 0)) == 2
    got = run(index, reads, mesh=two)
    assert routes == {"scan": 0, "step": 2}
    want = jrun(index, reads, mesh=JP.make_mesh(2, 2))
    assert_same(got, want)
    assert_same(run(index, reads, mesh=tmesh(2, 2)), want)
    assert routes == {"scan": 2, "step": 2}


@pytest.mark.parametrize("wide_engine,step_offset", [(False, 0), (True, 0),
                                                     (True, 40)])
def test_step_route_equals_chunk_route(narrow, wide, routes, wide_engine,
                                       step_offset):
    """`step_chunk` called directly on a one-device mesh equals the chunk
    route `scan_chunk` takes there: outputs and the carried state."""
    index, reads = (wide[1], wide[2]) if wide_engine else narrow
    mesh = tmesh(1, 4)
    st = (TSW.shard_mega_wide(index, mesh) if wide_engine
          else TSM.shard_mega(index, mesh))
    enc, lens = index.encode_patterns(reads, None)
    p = torch.from_numpy(enc.astype(np.uint8))
    ln = torch.from_numpy(lens) + step_offset
    if wide_engine:
        state = TSW.initial_state_sharded(st, p.shape[0], mesh)[0]
    else:
        B = p.shape[0]
        state = tuple(torch.full((B,), v, dtype=torch.int32)
                      for v in (st["r"] - 1, st["last_len"] - 1,
                                st["n"] - 1, 0))
    s1 = tuple(t.clone() for t in state)
    s2 = tuple(t.clone() for t in state)
    got = TSM.scan_chunk(mesh, st, 0, p, ln, s1, step_offset,
                         index.ff_bound, wide_engine)
    assert routes == {"scan": 1, "step": 0}
    want = TSM.step_chunk(mesh, st, 0, p, ln, s2, step_offset,
                          index.ff_bound, wide_engine)
    assert routes == {"scan": 1, "step": 1}
    for a, b in zip(got + s1, want + s2):
        assert torch.equal(a, b)
    assert bool(got[0].any())
