"""The sharded positional engine's two routes (colbwt_tpu_torch/parallel/
query_sharded_pos.py) against the JAX package, on the CPU.

A dp row whose ip shards all sit on one device takes the chunk scan
`sharded_scan_pos` (here its plain version `sharded_scan_pos_ref`); shards
spread over devices take the per-step route `step_row` (a prepared fetch a
card summed over "ip", then `StepPos`, the launcher of the per-step kernel,
on (M, B) columns and an (M, B) plane).  The JAX engine runs on the
8-device virtual CPU mesh (tests/conftest.py), the port's on one-process
meshes over ["cpu"] * 8, or over ["cpu", "cpu:0"] (two device names, so two
"cards" on the CPU), on the same index and reads made from a numpy seed.
Every value is an integer, so every comparison is exact.
"""

import ctypes
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from colbwt_tpu import parallel as JP
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.parallel import query_sharded_pos as JSP
from colbwt_tpu_torch import parallel as TP
from colbwt_tpu_torch.parallel import mesh as TMESH
from colbwt_tpu_torch.parallel import query_sharded_pos as TSP
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

LAYOUTS = [(8, 1), (4, 2), (2, 4), (1, 8), (1, 5), (2, 3)]


def one_device(dp, ip):
    return TP.make_mesh(dp, ip, devices=["cpu"] * 8)


def two_devices(dp, ip):
    """A mesh whose rows span the device names "cpu" and "cpu:0" where ip
    > 1: two cards as one process sees them."""
    return TP.make_mesh(dp, ip, devices=["cpu", "cpu:0"] * 4)


def assert_same(got, want):
    (gp, gc), (wp, wc) = got, want
    assert len(gp) == len(gc) == len(wp)
    for j in range(len(wp)):
        np.testing.assert_array_equal(gp[j], wp[j], err_msg=f"pml {j}")
        np.testing.assert_array_equal(gc[j], wc[j], err_msg=f"cid {j}")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0x5E05)
    base = bytes(rng.choice(list(b"ACGT"), 260).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.from_table(tbl)
    # ragged against every dp; an empty read, an N read, one longer read
    reads = make_reads(rng, docs, 13) + [b"", b"NNACGTN", docs[1][5:140]]
    return index, reads


@pytest.fixture
def routes(monkeypatch):
    """Counts of the dp rows each route of `scan_row` took."""
    seen = {"scan": 0, "step": 0}
    scan, step = TSP.sharded_scan_pos, TSP.step_row

    def spy_scan(*a, **kw):
        seen["scan"] += 1
        return scan(*a, **kw)

    def spy_step(*a, **kw):
        seen["step"] += 1
        return step(*a, **kw)

    monkeypatch.setattr(TSP, "sharded_scan_pos", spy_scan)
    monkeypatch.setattr(TSP, "step_row", spy_step)
    return seen


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("dp,ip", LAYOUTS)
def test_both_routes_match_jax(case, routes, monkeypatch, dp, ip, k):
    """The chunk scan (a one-device mesh) and the per-step route (every
    row through `step_row`, its shards over two device names where ip > 1)
    equal JAX's query_batch_sharded_pos: ip dividing n or not, dp padding
    rows, k = 1-4 (each allowed by choose_k_sharded)."""
    index, reads = case
    assert TSP.choose_k_sharded(index, ip) >= k
    want = JSP.query_batch_sharded_pos(index, reads,
                                       mesh=JP.make_mesh(dp, ip), k=k)
    assert_same(TSP.query_batch_sharded_pos(index, reads,
                                            mesh=one_device(dp, ip), k=k),
                want)
    assert routes == {"scan": dp, "step": 0}
    monkeypatch.setattr(TSP, "scan_row", TSP.step_row)
    assert_same(TSP.query_batch_sharded_pos(index, reads,
                                            mesh=two_devices(dp, ip), k=k),
                want)
    assert routes == {"scan": dp, "step": dp}


@pytest.mark.parametrize("dp,ip", [(2, 2), (1, 4), (2, 3)])
def test_route_follows_where_shards_lie(case, routes, dp, ip):
    """Rows over one device name take the chunk scan, one call a row; rows
    whose shards lie over two device names take `step_row`; both equal
    JAX's engine."""
    index, reads = case
    want = JSP.query_batch_sharded_pos(index, reads,
                                       mesh=JP.make_mesh(dp, ip), k=2)
    assert_same(TSP.query_batch_sharded_pos(index, reads,
                                            mesh=one_device(dp, ip), k=2),
                want)
    assert routes == {"scan": dp, "step": 0}
    two = two_devices(dp, ip)
    assert_same(TSP.query_batch_sharded_pos(index, reads, mesh=two, k=2),
                want)
    assert all(len(two.card_shards(two.shard(lambda i, dev: i), d)) == 2
               for d in range(dp))
    assert routes == {"scan": dp, "step": dp}


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_step_route_equals_chunk_scan(case, k):
    """From the same start state (pos n - 1, length 0), `step_row` over two
    device names equals the chunk scan on one: random dense ids of every
    key (the terminator's id among them), one step (M = k) and 40/k steps,
    and the empty batches B = 0 and M = 0."""
    index, _ = case
    ip = 3
    rng = np.random.default_rng(k)
    one, two = one_device(1, ip), two_devices(1, ip)
    st1 = TSP.shard_pos_tables(index, one, k=k)
    st2 = TSP.shard_pos_tables(index, two, k=k)
    A = st1["A"]
    for B, M in ((37, k), (37, k * (40 // k)), (0, 2 * k), (5, 0)):
        pats = torch.from_numpy(rng.integers(0, A, (B, M)).astype(np.uint8))
        got = TSP.step_row(two, st2, 0, pats)
        want = TSP.scan_row(one, st1, 0, pats)
        assert got.shape == want.shape == (B, M)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)
        if B and M > k:
            assert bool((got >> 8).any())


def _random_table(rng, ip: int, L: int, A: int, k: int) -> np.ndarray:
    """An (ip · A**k · L, 2) int32 T_k whose rows land on positions past
    every shard (>= ip·L) for about a third of them, with random match
    bits and col ids."""
    rows = ip * A ** k * L
    pb = 32 - k
    pos = rng.integers(0, ip * L, rows)
    far = rng.random(rows) < 0.35
    pos[far] = rng.integers(ip * L, ip * L + 60, int(far.sum()))
    bits = rng.integers(0, 1 << k, rows)
    w0 = (pos | (bits << pb)).astype(np.uint32).view(np.int32)
    w1 = rng.integers(0, 1 << 32, rows, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    return np.stack([w0, w1], axis=1)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("step", [False, True])
def test_state_outside_every_shard_reads_zeros(k, step):
    """A table whose rows send a lane to positions that no shard owns
    (past the padded ip·L): both routes read those rows as zeros, not
    clamped into the last shard, as JAX's masked take summed over "ip";
    dense ids of A (past the keys) clip the row index to the shard, as
    mode="clip" does.  Outputs equal JAX's _sharded_pos_query on the same
    table and batch."""
    dp, ip, L, A = 2, 4, 23, 3
    n = ip * L - 5  # ip does not divide n: the last shard has padding
    rng = np.random.default_rng(10 * k + step)
    table = _random_table(rng, ip, L, A, k)
    B, M = 10, 6 * k
    pats = rng.integers(0, A, (B, M)).astype(np.uint8)
    pats[0, ::5] = A  # keys past A**k - 1
    jm = JP.make_mesh(dp, ip)
    jt = jax.device_put(table, NamedSharding(jm, P("ip", None)))
    jpat = jax.device_put(pats.astype(np.int32),
                          NamedSharding(jm, P("dp", None)))
    jlen = jax.device_put(np.full(B, M, np.int32), NamedSharding(jm, P("dp")))
    jp, jc = JSP._sharded_pos_query(jm, jt, jpat, jlen, n=n, n_local=L, A=A,
                                    k=k)
    mesh = two_devices(dp, ip) if step else one_device(dp, ip)
    st = {"table": mesh.shard(lambda i, dev: torch.from_numpy(
        table[i * A ** k * L:(i + 1) * A ** k * L].copy())),
        "n": n, "n_local": L, "k": k, "A": A}
    route = TSP.step_row if step else TSP.scan_row
    bl = B // dp
    seen_far = False
    for d in range(dp):
        sl = slice(d * bl, (d + 1) * bl)
        packed = route(mesh, st, d, torch.from_numpy(pats[sl].copy()))
        np.testing.assert_array_equal((packed >> 8).numpy(),
                                      np.asarray(jp)[sl])
        np.testing.assert_array_equal((packed & 0xFF).numpy(),
                                      np.asarray(jc)[sl])
        seen_far |= bool((packed == 0).any())
    assert seen_far


def _step_args(B: int = 6, M: int = 6, k: int = 3):
    """Valid CPU arguments of StepPos."""
    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    return [i32(B, 2), i32(B), i32(B), torch.zeros((M, B), dtype=torch.uint8),
            k, 5, i32(M, B), i32(B), i32(B)]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values at an address 4 bytes past an 8-byte boundary."""
    buf = torch.zeros(t.numel() + 2, dtype=t.dtype)
    k = next(k for k in range(1, 3) if (buf.data_ptr() + 4 * k) % 8)
    return buf[k:k + t.numel()].view(t.shape)


@pytest.mark.parametrize("fault", ["dtype", "device", "shape", "alignment",
                                   "k", "layout"])
def test_step_pos_checks_at_the_batch_start(fault):
    """StepPos, the launcher made once a batch, makes the checks the
    per-call wrapper made, when it is made, and raises ValueError there: a
    wrong dtype, a tensor on another device ("meta" against the CPU), a
    wrong shape, rows off their 8-byte alignment, M not a multiple of k,
    patterns that are not two-dimensional.  The valid arguments make it
    without a complaint, and a step out of range raises at the call."""
    args = _step_args()
    step = TSP.StepPos(*args)
    with pytest.raises(ValueError):
        step(2)
    bad = list(args)
    if fault == "dtype":
        bad[1] = bad[1].to(torch.int64)
    elif fault == "device":
        bad[7] = torch.empty_like(bad[7], device="meta")
    elif fault == "shape":
        bad[6] = bad[6][:-1]
    elif fault == "alignment":
        bad[0] = _misaligned(bad[0])
    elif fault == "k":
        bad[4] = 4
    else:
        bad[3] = bad[3].reshape(-1)
    with pytest.raises(ValueError):
        TSP.StepPos(*bad)


def test_step_route_raises_before_its_first_step(case, monkeypatch):
    """`step_row` with int64 dense ids: StepPos's checks raise at the
    batch's start, before any fetch or step."""
    index, reads = case
    mesh = two_devices(1, 2)
    st = TSP.shard_pos_tables(index, mesh, k=2)
    calls = []
    monkeypatch.setattr(TSP, "sharded_step_pos_ref",
                        lambda *a: calls.append("step"))
    monkeypatch.setattr(TMESH, "sharded_fetch_ref",
                        lambda *a, **kw: calls.append("fetch"))
    enc, _ = index.encode_patterns(reads, 150)
    with pytest.raises(ValueError, match="patterns"):
        TSP.step_row(mesh, st, 0, torch.from_numpy(enc.astype(np.int64)))
    assert not calls


def test_parameter_block_matches_the_c_struct():
    """The ctypes parameter block that StepPos fills names the fields of
    csrc/query_sharded.cu's StepPosArgs in their order, every one 8 bytes
    (pointers and int64), so the layouts agree."""
    src = (Path(TSP.__file__).resolve().parents[1] / "csrc"
           / "query_sharded.cu").read_text()
    body = re.search(r"struct StepPosArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";")[:-1]:
        decl = re.sub(r"\b(const|void|int64_t)\b", "", decl)
        names += [x.strip(" *\n") for x in decl.split(",")]
    assert names == [name for name, _ in TSP._StepPosArgs._fields_]
    assert ctypes.sizeof(TSP._StepPosArgs) == 8 * len(names)
