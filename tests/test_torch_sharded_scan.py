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


@pytest.fixture(scope="module")
def ff_indexes(wide):
    """`narrow`'s and `wide`'s collections split at ff_bound 2-4 (the mega
    engines need a run-split index with ff_bound >= 2): {(wide, ff):
    index}."""
    rng = np.random.default_rng(0x5CA7)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    tbl, _ = build_index(random_docs(rng, 3, mutate_from=base))
    return {(w, ff): ColPmlIndex.build(wide[0] if w else tbl, ff_bound=ff)
            for w in (False, True) for ff in (2, 3, 4)}


def _chunk_lanes(index, C: int, step_offset: int, rng):
    """A (B, C) chunk of dense ids and per-lane read lengths that end at
    every kind of place: 0 and 1 character, past the chunk, at its edge
    and mid-chunk (lengths count from the read's end, so a lane is valid
    at step s while step_offset + s < length)."""
    B = 12
    reads = [bytes(rng.choice(list(b"ACGTN"), C).astype("uint8"))
             for _ in range(B)]
    enc, _ = index.encode_patterns(reads, C)
    ends = np.array([0, 1, C + 7, C, 5, 17, 30, C - 1, C + 100, 2, 0, 25])
    lens = np.where(ends > 1, ends + step_offset, ends).astype(np.int32)
    return enc.astype(np.uint8), lens


def _start_state(st: dict, B: int, wide: bool):
    full = (lambda v: np.full((B,), v, dtype=np.int32))
    if wide:
        vals = (st["r"] - 1, st["last_len"] - 1, st["pos0_lo"],
                st["pos0_hi"], 0)
    else:
        vals = (st["r"] - 1, st["last_len"] - 1, st["n"] - 1, 0)
    return tuple(full(v) for v in vals)


@pytest.mark.parametrize("wide_engine,step_offset,ff", [
    # the first three keep the ids they had before the ff_bound grid
    pytest.param(w, so, ff, id=f"{w}-{so}" if ff == 2 and (w, so) != (
        False, 40) else f"{w}-{so}-ff{ff}")
    for ff in (2, 3, 4) for w, so in ((False, 0), (True, 0), (False, 40),
                                      (True, 40))])
def test_step_route_equals_chunk_route(ff_indexes, routes, wide_engine,
                                       step_offset, ff):
    """The per-step route (a row over two device names, "cpu" and "cpu:0":
    a prepared fetch a card summed over "ip", the step on (C, B) columns
    and planes) equals the chunk route `scan_chunk` takes on a one-device
    mesh and JAX's programs, in outputs and carried state: narrow,
    `_sharded_mega_query` from its start state (the lengths shifted by
    step_offset, so the same steps are valid); wide,
    `_sharded_mega_wide_chunk` from a state carried out of an earlier
    chunk of 40 columns.  Reads of 0 and 1 characters, past the chunk and
    ending mid-chunk; ff_bound 2-4."""
    index = ff_indexes[wide_engine, ff]
    assert index.ff_bound == ff
    C, ip = 48, 4
    rng = np.random.default_rng(ff * 10 + step_offset + wide_engine)
    enc, lens = _chunk_lanes(index, C, step_offset, rng)
    B = enc.shape[0]
    one = tmesh(1, ip)
    two = tmesh(1, ip, devices=["cpu", "cpu:0"] * 2)
    assert len(two.card_shards(two.shard(lambda i, dev: i), 0)) == 2
    shard = TSW.shard_mega_wide if wide_engine else TSM.shard_mega
    st1, st2 = shard(index, one), shard(index, two)
    state = _start_state(st1, B, wide_engine)
    jm = JP.make_mesh(1, ip)
    if wide_engine and step_offset:
        # the state an earlier chunk of 40 columns leaves, from the start
        first, _ = _chunk_lanes(index, step_offset, 0, rng)
        st0 = tuple(torch.from_numpy(a.copy()) for a in state)
        TSM.scan_chunk(one, st1, 0, torch.from_numpy(first),
                       torch.from_numpy(lens), st0, 0, ff, True)
        assert routes == {"scan": 1, "step": 0}
        state = tuple(t.numpy().copy() for t in st0)
        routes.update(scan=0)
    got = {}
    for name, mesh, st in (("step", two, st2), ("scan", one, st1)):
        s = tuple(torch.from_numpy(a.copy()) for a in state)
        out = TSM.scan_chunk(mesh, st, 0, torch.from_numpy(enc),
                             torch.from_numpy(lens), s, step_offset, ff,
                             wide_engine)
        got[name] = [t.numpy() for t in out + s]
    assert routes == {"scan": 1, "step": 1}
    for a, b in zip(got["step"], got["scan"]):
        np.testing.assert_array_equal(a, b)
    if wide_engine:
        jst = JSW.shard_mega_wide(index, jm)
        (jp, jc), jfinal = JSW._sharded_mega_wide_chunk(
            jm, jst["mega"], jst["length"], enc.astype(np.int32), lens,
            state, np.int32(step_offset), jst["rows_padded"] // ip, jst["n_lo"],
            jst["n_hi"], jst["r"], ff_bound=ff)
        want = [jp, jc, *jfinal]
    else:
        jst = JSM.shard_mega(index, jm)
        want = list(JSM._sharded_mega_query(
            jm, jst["mega"], jst["length"], enc.astype(np.int32),
            lens - np.where(
                lens > 1, step_offset, 0).astype(np.int32),
            jst["rows_padded"] // ip, jst["n"], jst["r"], jst["last_len"],
            ff_bound=ff))
    for a, b in zip(got["step"], want):
        np.testing.assert_array_equal(a, np.asarray(b))
    valid = (np.arange(C)[None, ::-1] + step_offset) < lens[:, None]
    assert not got["step"][0][~valid].any()
    assert got["step"][0][valid].any()


def _launch_args(wide: bool, B: int = 6, C: int = 5):
    """Valid CPU arguments of StepMega (wide or narrow) and RoundCompact."""
    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    pats = torch.zeros((C, B), dtype=torch.uint8)
    state = tuple(i32(B) for _ in range(5 if wide else 4))
    mega = [i32(B, 16), i32(9), 3, 7, 0, state, pats, i32(B), 0, 2,
            i32(C, B), i32(C, B), i32(B), wide]
    compact = [i32(B, 8), i32(B, 2), i32(B, 8), i32(9, B),
               tuple(i32(B) for _ in range(4)), pats, i32(B), 3, 7, 2,
               i32(C, B), i32(C, B), i32(B), i32(B), i32(B)]
    return mega, compact


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values at an address 4 bytes past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype)
    k = next(k for k in range(1, 4) if (buf.data_ptr() + 4 * k) % 16)
    return buf[k:k + t.numel()].view(t.shape)


@pytest.mark.parametrize("launcher,fault", [
    (name, fault)
    for name in ("StepMega narrow", "StepMega wide", "RoundCompact", "Fetch")
    for fault in ("dtype", "device", "shape", "alignment", "arity")
    if (name, fault) not in (("Fetch", "arity"),
                             ("RoundCompact", "alignment"))])
def test_launchers_check_at_the_chunk_start(launcher, fault):
    """The launchers made once a chunk (StepMega, RoundCompact, the
    prepared fetch) make the checks the per-call wrappers made, when they
    are made, and raise ValueError there: a wrong dtype, a tensor on
    another device (the devices compared as objects: "meta" against the
    CPU), a wrong shape, rows off their 16-byte alignment, a state of the
    wrong arity.  The valid arguments make them without a complaint."""
    from colbwt_tpu_torch.parallel import query_sharded as TS

    wide = launcher.endswith("wide")
    mega, compact = _launch_args(wide)
    if launcher == "Fetch":
        args = [[torch.zeros((9, 16), dtype=torch.int32)] * 2,
                torch.zeros(6, dtype=torch.int32), None, 9, 0,
                torch.zeros((6, 16), dtype=torch.int32)]
        make, at = TMESH.Fetch, {"dtype": 1, "device": 1, "shape": 5,
                                 "alignment": 0}
    elif launcher == "RoundCompact":
        args, make = compact, TS.RoundCompact
        at = {"dtype": 6, "device": 12, "shape": 3, "arity": 4}
    else:
        args, make = mega, TSM.StepMega
        at = {"dtype": 7, "device": 12, "shape": 10, "alignment": 0,
              "arity": 5}
    make(*args)  # valid
    j = at[fault]
    bad = list(args)
    if fault == "dtype":
        bad[j] = bad[j].to(torch.int64)
    elif fault == "device":
        bad[j] = torch.empty_like(bad[j], device="meta")
    elif fault == "shape":
        bad[j] = bad[j][:-1]
    elif fault == "alignment":
        bad[j] = ([_misaligned(t) for t in bad[j]] if isinstance(bad[j], list)
                  else _misaligned(bad[j]))
    else:
        bad[j] = bad[j][:-1]
    with pytest.raises(ValueError):
        make(*bad)


def test_step_route_raises_before_its_first_step(narrow, monkeypatch):
    """`step_chunk` with int64 lengths: the launcher's checks raise at the
    chunk's start, before any fetch or step, and the state is untouched."""
    index, reads = narrow
    mesh = tmesh(1, 2, devices=["cpu", "cpu:0"])
    st = TSM.shard_mega(index, mesh)
    enc, lens = index.encode_patterns(reads, None)
    B = enc.shape[0]
    state = tuple(torch.full((B,), v, dtype=torch.int32)
                  for v in (st["r"] - 1, st["last_len"] - 1, st["n"] - 1, 0))
    steps = []
    monkeypatch.setattr(TSM, "sharded_step_mega_ref",
                        lambda *a: steps.append(a))
    with pytest.raises(ValueError, match="lengths"):
        TSM.step_chunk(mesh, st, 0, torch.from_numpy(enc.astype(np.uint8)),
                       torch.from_numpy(lens.astype(np.int64)), state, 0,
                       index.ff_bound, False)
    assert not steps
    assert int(state[0][0]) == st["r"] - 1 and not state[3].any()


@pytest.mark.parametrize("struct,block", [
    ("StepMegaArgs", "query_sharded_mega._StepMegaArgs"),
    ("RoundCompactArgs", "query_sharded._RoundCompactArgs")])
def test_parameter_block_matches_the_c_struct(struct, block):
    """The ctypes parameter blocks that the launchers fill name the fields
    of csrc/query_sharded.cu's structs in their order, every one 8 bytes
    (pointers and int64), so the layouts agree."""
    import ctypes
    import importlib
    import re
    from pathlib import Path

    module, cls = block.rsplit(".", 1)
    py = getattr(importlib.import_module(
        f"colbwt_tpu_torch.parallel.{module}"), cls)
    src = (Path(TSM.__file__).resolve().parents[1] / "csrc"
           / "query_sharded.cu").read_text()
    body = re.search(r"struct " + struct + r" \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";")[:-1]:
        decl = re.sub(r"\b(const|void|int64_t)\b", "", decl)
        names += [x.strip(" *\n") for x in decl.split(",")]
    assert names == [name for name, _ in py._fields_]
    assert ctypes.sizeof(py) == 8 * len(names)
