"""The sharded compact engine's two routes (colbwt_tpu_torch/parallel/
query_sharded.py) against the JAX package, on the CPU.

A dp row whose ip shards all sit on one device takes the chunk scan
`sharded_scan_compact` (here its plain version `sharded_scan_compact_ref`);
shards spread over devices take the per-round route `round_row`.  The JAX
engine runs on the 8-device virtual CPU mesh (tests/conftest.py), the
port's on one-process meshes over ["cpu"] * 8 (the chunk route) or over
["cpu", "cpu:0"] (two device names, so two "cards" on the CPU: the
per-round route), on the same index and reads made from a numpy seed.
Every value is an integer, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from colbwt_tpu import parallel as JP
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops.query_xla import query_step
from colbwt_tpu.parallel import mesh as JMESH
from colbwt_tpu.parallel import query_sharded as JS
from colbwt_tpu_torch import parallel as TP
from colbwt_tpu_torch.parallel import mesh as TMESH
from colbwt_tpu_torch.parallel import query_sharded as TS
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

LAYOUTS = [(8, 1), (4, 2), (2, 4), (1, 8)]


def tmesh(dp, ip, route):
    """The port's mesh whose rows take `route`: one device name ("scan"),
    or ip shards over two device names ("round")."""
    devices = ["cpu"] * 8 if route == "scan" else ["cpu", "cpu:0"] * 4
    return TP.make_mesh(dp, ip, devices=devices)


def assert_same(got, want):
    (gp, gc), (wp, wc) = got, want
    assert len(gp) == len(gc) == len(wp)
    for j in range(len(wp)):
        np.testing.assert_array_equal(gp[j], wp[j], err_msg=f"pml {j}")
        np.testing.assert_array_equal(gc[j], wc[j], err_msg=f"cid {j}")


@pytest.fixture
def routes(monkeypatch):
    """Counts of the dp rows each route took."""
    seen = {"scan": 0, "round": 0}
    scan, rnd = TS.sharded_scan_compact, TS.round_row

    def spy_scan(*a, **kw):
        seen["scan"] += 1
        return scan(*a, **kw)

    def spy_round(*a, **kw):
        seen["round"] += 1
        return rnd(*a, **kw)

    monkeypatch.setattr(TS, "sharded_scan_compact", spy_scan)
    monkeypatch.setattr(TS, "round_row", spy_round)
    return seen


@pytest.fixture(scope="module")
def case():
    """One collection split at ff_bound 1-4, and ragged reads with an empty
    read and N reads among them."""
    rng = np.random.default_rng(0xC0F7)
    base = bytes(rng.choice(list(b"ACGT"), 280).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    split = {ff: ColPmlIndex.build(tbl, ff_bound=ff) for ff in (1, 2, 3, 4)}
    reads = make_reads(rng, docs, 13) + [b"", b"NNACGT", b"G"]
    return tbl, split, reads


@pytest.fixture(scope="module")
def jax_reference(case):
    """JAX's query_batch_sharded of `case`'s reads, once per (ff_bound,
    layout)."""
    _, split, reads = case
    memo = {}

    def get(ff, dp, ip):
        if (ff, dp, ip) not in memo:
            memo[ff, dp, ip] = JS.query_batch_sharded(
                split[ff], reads, mesh=JP.make_mesh(dp, ip))
        return memo[ff, dp, ip]

    return get


# ---------------------------------------------------------------------------
# both routes at every layout of tests/test_parallel.py


@pytest.mark.parametrize("route", ["scan", "round"])
@pytest.mark.parametrize("ff", [1, 2, 3])
@pytest.mark.parametrize("dp,ip", LAYOUTS)
def test_routes_match_jax(case, jax_reference, routes, monkeypatch, dp,
                          ip, ff, route):
    """query_batch_sharded through the chunk scan (one call a dp row) and
    through the per-round route equals JAX's _sharded_query, and the
    oracle.  An ip = 1 row always holds its one shard on its device, so
    there the per-round route is forced, as a row spread over cards takes
    it."""
    tbl, split, reads = case
    index = split[ff]
    assert index.ff_bound == ff
    if route == "round" and ip == 1:
        monkeypatch.setattr(TS, "scan_row", TS.round_row)
    got = TS.query_batch_sharded(index, reads, mesh=tmesh(dp, ip, route))
    assert routes == ({"scan": dp, "round": 0} if route == "scan"
                      else {"scan": 0, "round": dp})
    assert_same(got, jax_reference(ff, dp, ip))
    for j in range(0, len(reads), 4):
        np.testing.assert_array_equal(got[0][j],
                                      O.query_pml_oracle(tbl, reads[j])[0])


@pytest.mark.parametrize("ff", [1, 2, 3])
def test_routes_equal_each_other(case, routes, ff):
    """`scan_row`'s chunk scan and `round_row` called on the same one-device
    mesh, a ragged batch with empty reads, the same carried state: equal
    outputs and equal final state."""
    _, split, reads = case
    index = split[ff]
    mesh = TP.make_mesh(1, 4, devices=["cpu"] * 4)
    tb = TMESH.shard_index(index, mesh)
    enc, lens = index.encode_patterns(reads + [b"", b"AC"], None)
    assert (lens == 0).sum() >= 2 and len(set(lens.tolist())) > 3
    p = torch.from_numpy(enc.astype(np.uint8))
    ln = torch.from_numpy(lens)
    B = p.shape[0]
    rng = np.random.default_rng(ff)
    state = (torch.from_numpy(rng.integers(0, index.r, B).astype(np.int32)),
             torch.zeros((B,), dtype=torch.int32),
             torch.from_numpy(rng.integers(0, index.n, B).astype(np.int32)),
             torch.from_numpy(rng.integers(0, 5, B).astype(np.int32)))
    s1 = tuple(t.clone() for t in state)
    s2 = tuple(t.clone() for t in state)
    got = TS.scan_row(mesh, tb, 0, p, ln, s1, index.ff_bound)
    want = TS.round_row(mesh, tb, 0, p, ln, s2, index.ff_bound)
    assert routes == {"scan": 1, "round": 1}
    for a, b in zip(got + s1, want + s2):
        assert torch.equal(a, b)
    assert bool(got[0].any())
    empty = ln == 0
    assert not bool(got[0][empty].any()) and not bool(got[1][empty].any())
    for a, b in zip(s1, state):
        assert torch.equal(a[empty], b[empty])


@pytest.mark.parametrize("route", ["scan", "round"])
@pytest.mark.parametrize("dp,ip", [(1, 5), (2, 3)])
def test_ip_not_dividing_runs(case, jax_reference, routes, dp, ip, route):
    """ip does not divide r: the last shard ends in padding rows, which
    stay inert; both routes equal JAX's engine."""
    _, split, reads = case
    index = split[2]
    assert index.r % ip
    got = TS.query_batch_sharded(index, reads, mesh=tmesh(dp, ip, route))
    assert routes[route] == dp
    assert_same(got, jax_reference(2, dp, ip))


def _jax_scan_from(mesh, tb, pats, lens, state, ff_bound):
    """JAX's sharded compact scan (_sharded_query's shard_fn: its masked
    gathers summed over "ip" and query_step) started from a given state;
    returns (pml, cid, *final state) as numpy arrays."""
    tb = dict(tb)
    r_local = tb.pop("r_padded") // mesh.shape["ip"]
    n, r = tb.pop("n"), tb.pop("r")
    specs = {k: P(None, "ip") if v.ndim == 2 else P("ip")
             for k, v in tb.items()}

    def shard_fn(tb_local, pats, lens, *state):
        loc = dict(tb_local)
        loc["n"], loc["r"] = jnp.int32(n), jnp.int32(r)
        gather, gather_jump = JS._local_gathers(tb_local, r_local)
        M = pats.shape[1]

        def body(st, xs):
            ccol, i = xs
            return query_step(loc, st, ccol, i < lens, ff_bound,
                              gather=gather, gather_jump=gather_jump)

        final, (pml, cid) = jax.lax.scan(
            body, tuple(state),
            (pats[:, ::-1].T.astype(jnp.int32), jnp.arange(M,
                                                          dtype=jnp.int32)))
        return (pml.T[:, ::-1], cid.T[:, ::-1]) + tuple(final)

    out = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(specs, P("dp", None), P("dp")) + (P("dp"),) * 4,
        out_specs=(P("dp", None),) * 2 + (P("dp"),) * 4,
        check_vma=False)(tb, pats, lens, *state)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("route", ["scan", "round"])
def test_state_outside_every_shard_reads_zeros(case, routes, route):
    """Carried intervals below 0 and past every shard: both routes read
    those rows as zeros (not clamped into the table), as JAX's masked take
    summed over "ip"; outputs and final state equal JAX's scan from the
    same state."""
    _, split, reads = case
    index = split[2]
    dp, ip = 2, 4
    enc, lens = index.encode_patterns(reads[:12], None)
    B = enc.shape[0]
    rng = np.random.default_rng(0x0FF)
    tm = tmesh(dp, ip, route)
    tb = TMESH.shard_index(index, tm)
    interval = rng.integers(0, index.r, B).astype(np.int32)
    interval[0::3] = tb["r_padded"] + 3 * np.arange(len(interval[0::3]))
    interval[1::3] = -5 - 7 * np.arange(len(interval[1::3]))
    state = (interval, rng.integers(0, 9, B).astype(np.int32),
             rng.integers(0, index.n, B).astype(np.int32),
             rng.integers(0, 4, B).astype(np.int32))
    jm = JP.make_mesh(dp, ip)
    want = _jax_scan_from(jm, JMESH.shard_index(index, jm), enc, lens, state,
                          index.ff_bound)
    bl = B // dp
    for d in range(dp):
        sl = slice(d * bl, (d + 1) * bl)
        st = tuple(torch.from_numpy(a[sl].copy()) for a in state)
        got = TS.scan_row(tm, tb, d,
                          torch.from_numpy(enc[sl].astype(np.uint8)),
                          torch.from_numpy(lens[sl]), st, index.ff_bound)
        for a, b in zip(got + st, want):
            np.testing.assert_array_equal(a.numpy(), b[sl])
    assert routes[route] == dp


@pytest.mark.parametrize("ff", [1, 2, 3, 4])
def test_round_route_matches_jax_from_state(case, routes, ff):
    """The per-round route (a row over two device names: a prepared fetch a
    card summed over "ip", the rounds on (M, B) columns and planes; round
    5 at ff_bound >= 3) from a carried state equals JAX's _sharded_query
    scan from that state and the chunk route, in outputs and final state.
    Reads of 0 and 1 characters, longer than the batch's M and ending
    mid-batch."""
    _, split, reads = case
    index = split[ff]
    M, ip = 40, 4
    rng = np.random.default_rng(0xF0 + ff)
    enc, _ = index.encode_patterns(
        [bytes(rng.choice(list(b"ACGTN"), M).astype("uint8"))
         for _ in range(12)], M)
    lens = np.array([0, 1, M + 7, M, 5, 17, 30, M - 1, M + 100, 2, 0, 25],
                    dtype=np.int32)
    B = enc.shape[0]
    state = (rng.integers(0, index.r, B).astype(np.int32),
             np.zeros(B, dtype=np.int32),
             rng.integers(0, index.n, B).astype(np.int32),
             rng.integers(0, 5, B).astype(np.int32))
    jm = JP.make_mesh(1, ip)
    want = _jax_scan_from(jm, JMESH.shard_index(index, jm), enc, lens,
                          state, ff)
    got = {}
    for route in ("round", "scan"):
        tm = tmesh(1, ip, route)
        st = tuple(torch.from_numpy(a.copy()) for a in state)
        out = TS.scan_row(tm, TMESH.shard_index(index, tm), 0,
                          torch.from_numpy(enc.astype(np.uint8)),
                          torch.from_numpy(lens), st, ff)
        got[route] = [t.numpy() for t in out + st]
    assert routes == {"scan": 1, "round": 1}
    for a, b, w in zip(got["round"], got["scan"], want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    assert got["round"][0].any()
    assert not got["round"][0][lens == 0].any()


def test_round_route_raises_before_its_first_round(case, monkeypatch):
    """`round_row` with a state of the wrong dtype: the launcher's checks
    raise at the batch's start, before any round, and the state is
    untouched."""
    _, split, reads = case
    index = split[2]
    tm = tmesh(1, 2, "round")
    tb = TMESH.shard_index(index, tm)
    enc, lens = index.encode_patterns(reads, None)
    B = enc.shape[0]
    state = (torch.full((B,), index.r - 1, dtype=torch.int32),
             torch.zeros(B, dtype=torch.int64),
             torch.full((B,), index.n - 1, dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32))
    calls = []
    monkeypatch.setattr(TS, "sharded_step_compact_ref",
                        lambda *a: calls.append(a))
    with pytest.raises(ValueError, match=r"state\[1\]"):
        TS.round_row(tm, tb, 0, torch.from_numpy(enc.astype(np.uint8)),
                     torch.from_numpy(lens), state, index.ff_bound)
    assert not calls
    assert int(state[0][0]) == index.r - 1 and not state[1].any()
