"""The port's sharded engines (colbwt_tpu_torch/parallel/) against the JAX
package's on the same layouts.

Each case mirrors one of tests/test_parallel.py: the JAX engine runs on its
8-device virtual CPU mesh (tests/conftest.py), the port's on a one-process
mesh over ["cpu"] * 8 (the plain PyTorch versions of K13a-K13e), on the
same index and reads.  Every value is an integer, so every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from colbwt_tpu import parallel as JP
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_mega as JM
from colbwt_tpu.ops import query_mega_wide as JW
from colbwt_tpu.parallel import query_sharded_mega as JSM
from colbwt_tpu.parallel import query_sharded_mega_wide as JSW
from colbwt_tpu.parallel import query_sharded_pos as JSP
from colbwt_tpu_torch import parallel as TP
from colbwt_tpu_torch.ops import query_mega_wide as TW
from colbwt_tpu_torch.parallel import mesh as TMESH
from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW
from colbwt_tpu_torch.parallel import query_sharded_pos as TSP
from tests.conftest import random_docs
from tests.test_query_wide import scale_table
from tests.test_query_xla import build_index, make_reads

CPUS = ["cpu"] * 8


def tmesh(dp, ip):
    return TP.make_mesh(dp, ip, devices=CPUS)


def assert_same(got, want, B=None):
    (gp, gc), (wp, wc) = got, want
    B = len(wp) if B is None else B
    assert len(gp) == len(gc) == B
    for j in range(B):
        np.testing.assert_array_equal(gp[j], wp[j], err_msg=f"pml {j}")
        np.testing.assert_array_equal(gc[j], wc[j], err_msg=f"cid {j}")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=4)
    reads = make_reads(rng, docs, 24)
    return tbl, index, reads


@pytest.mark.parametrize("dp,ip", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_matches_jax(setup, dp, ip):
    """K13a at every layout of the JAX test, and equal to the oracle."""
    tbl, index, reads = setup
    got = TP.query_batch_sharded(index, reads, mesh=tmesh(dp, ip))
    assert_same(got, JP.query_batch_sharded(index, reads,
                                            mesh=JP.make_mesh(dp, ip)))
    for j in range(0, len(reads), 5):
        np.testing.assert_array_equal(got[0][j],
                                      O.query_pml_oracle(tbl, reads[j])[0])


def test_sharded_pads_ragged_batch(setup):
    """13 reads at dp = 8: the padding lanes must not disturb results, and
    only the 13 reads come back."""
    _, index, reads = setup
    assert_same(TP.query_batch_sharded(index, reads[:13], mesh=tmesh(8, 1)),
                JP.query_batch_sharded(index, reads[:13],
                                       mesh=JP.make_mesh(8, 1)), B=13)


def test_sharded_requires_split_index(setup):
    _, index, reads = setup
    unsplit = ColPmlIndex(
        **{f: getattr(index, f) for f in (
            "char", "idx", "length", "dest_interval", "dest_offset",
            "col_id", "threshold", "pred_jump", "succ_jump", "alphabet",
            "char_map", "n", "r", "bwt_r")}, ff_bound=0)
    for mod, mesh in ((JP, JP.make_mesh(2, 2)), (TP, tmesh(2, 2))):
        with pytest.raises(ValueError, match="run-split"):
            mod.query_batch_sharded(unsplit, reads[:8], mesh=mesh)


def test_mesh_validation(setup, monkeypatch):
    with pytest.raises(ValueError, match="devices"):
        TP.make_mesh(16, 2, devices=CPUS)
    mesh = tmesh(2, 4)
    assert mesh.shape == {"dp": 2, "ip": 4}
    assert [i for i, _ in mesh.row_cells(1)] == [0, 1, 2, 3]
    # the default devices are the CUDA devices: none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TP.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="is_available"):
        TP.query_batch_sharded(setup[1], [b"A"])


def test_shard_reads_validation(setup):
    _, index, reads = setup
    enc, lens = index.encode_patterns(reads[:6])
    with pytest.raises(ValueError, match="not divisible"):
        TP.shard_reads(enc, lens, tmesh(4, 2))
    rows = TP.shard_reads(enc, lens, tmesh(2, 4))
    assert sorted(rows) == [0, 1]
    np.testing.assert_array_equal(rows[1][0].numpy(), enc[3:])


def test_pad_rows_match_jax(setup):
    from colbwt_tpu.parallel.mesh import pad_rows

    _, index, _ = setup
    for ip in (1, 3, 8):
        got, want = TMESH.pad_rows(index, ip), pad_rows(index, ip)
        assert set(got) == set(want)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.fixture(scope="module")
def mega_setup():
    rng = np.random.default_rng(77)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index2 = ColPmlIndex.build(tbl, ff_bound=2)
    reads = make_reads(rng, docs, 17)  # ragged vs dp
    return index2, reads


@pytest.mark.parametrize("dp,ip", [(4, 2), (1, 8), (2, 2), (8, 1)])
def test_sharded_mega_matches_jax(mega_setup, dp, ip):
    """K13b at every layout of the JAX test, and equal to the single-card
    mega engine."""
    index2, reads = mega_setup
    got = TSM.query_batch_sharded_mega(index2, reads, mesh=tmesh(dp, ip))
    assert_same(got, JSM.query_batch_sharded_mega(index2, reads,
                                                  mesh=JP.make_mesh(dp, ip)))
    assert_same(got, JM.query_batch(index2, reads))


def test_sharded_mega_carries_jax_table(mega_setup):
    """A mega table built by the JAX package, handed over as `mt`, gives
    the same shards and outputs as the port's own."""
    index2, reads = mega_setup
    mesh = tmesh(2, 4)
    jmt = JM.build_mega_table(index2)
    st_j = TSM.shard_mega(index2, mesh, mt=jmt)
    st_t = TSM.shard_mega(index2, mesh)
    for key in st_t["mega"]:
        assert torch.equal(st_j["mega"][key], st_t["mega"][key])
    assert {k: st_j[k] for k in ("rows_padded", "n", "r", "last_len")} == \
        {k: st_t[k] for k in ("rows_padded", "n", "r", "last_len")}
    assert_same(TSM.query_batch_sharded_mega(index2, reads, mesh=mesh,
                                             st=st_j),
                TSM.query_batch_sharded_mega(index2, reads, mesh=mesh,
                                             st=st_t))


@pytest.mark.parametrize("dp,ip", [(4, 2), (1, 8), (2, 2), (8, 1)])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_sharded_pos_matches_jax(setup, dp, ip, k):
    """K13d and K13e for k = 1..3 at every layout of the JAX test."""
    _, index, reads = setup
    reads = reads[:17]  # ragged vs dp
    assert_same(
        TSP.query_batch_sharded_pos(index, reads, mesh=tmesh(dp, ip), k=k),
        JSP.query_batch_sharded_pos(index, reads, mesh=JP.make_mesh(dp, ip),
                                    k=k))


@pytest.mark.parametrize("ip", [1, 3])
def test_sharded_pos_tables_match_jax(setup, ip):
    """Each shard's T_k block (padding rows included, ip = 3 does not divide
    n) equals the JAX shard's."""
    _, index, _ = setup
    st_t = TSP.shard_pos_tables(index, tmesh(1, ip), k=2)
    st_j = JSP.shard_pos_tables(index, JP.make_mesh(1, ip), k=2)
    assert st_t["n_local"] == st_j["n_local"] and st_t["A"] == st_j["A"]
    want = np.asarray(st_j["table"])
    rows = want.shape[0] // ip
    for i in range(ip):
        np.testing.assert_array_equal(st_t["table"][("cpu", i)].numpy(),
                                      want[i * rows:(i + 1) * rows])


def test_sharded_pos_choose_k_relaxes_with_ip(setup):
    _, index, _ = setup
    A = index.sigma + 1
    one_shard_k2 = (A ** 2) * index.n * 8
    budget = one_shard_k2 // 2 + A * index.n * 8
    assert TSP.choose_k_sharded(index, 1, budget) == 1
    assert TSP.choose_k_sharded(index, 2, budget) >= 2
    for ip in (1, 2, 4, 8):
        for b in (budget, 10 << 30, 1000):
            assert (TSP.choose_k_sharded(index, ip, b)
                    == JSP.choose_k_sharded(index, ip, b))


# ---------------------------------------------------------------------------
# wide sharded engine + router


@pytest.fixture(scope="module")
def wide_setup():
    rng = np.random.default_rng(0xB17)
    base = bytes(rng.choice(list(b"ACGT"), 250).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    big = scale_table(tbl, 2**23)
    assert big.n > 2**31
    index = ColPmlIndex.build(big, ff_bound=2)
    assert index.wide
    reads = make_reads(rng, docs, 24) + [b"NNNNN", b"A"]
    ref = [O.query_pml_oracle(big, r) for r in reads]
    return index, reads, ([p for p, _ in ref], [c for _, c in ref])


@pytest.mark.parametrize("dp,ip", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_mega_wide_matches_jax_and_oracle(wide_setup, dp, ip):
    """K13c at every layout of the JAX test."""
    index, reads, ref = wide_setup
    got = TSW.query_batch_sharded_mega_wide(index, reads, mesh=tmesh(dp, ip))
    assert_same(got, ref)
    assert_same(got, JSW.query_batch_sharded_mega_wide(
        index, reads, mesh=JP.make_mesh(dp, ip)))


def test_sharded_mega_wide_long_reads(wide_setup):
    """Chunks of 64 from the right with carried state equal one scan of the
    whole read, and JAX's chunked scan."""
    index, reads, _ = wide_setup
    rng = np.random.default_rng(3)
    long_reads = [bytes(rng.choice(list(b"ACGTN"), 300).astype("uint8")),
                  reads[0] * 4, reads[1][:33]]
    mesh = tmesh(4, 2)
    got = TSW.query_long_reads_sharded_mega_wide(index, long_reads,
                                                 mesh=mesh, chunk=64)
    assert_same(got, TSW.query_batch_sharded_mega_wide(index, long_reads,
                                                       mesh=mesh))
    assert_same(got, JSW.query_long_reads_sharded_mega_wide(
        index, long_reads, mesh=JP.make_mesh(4, 2), chunk=64))


def test_router_matches_jax(wide_setup, setup):
    wide_index, wide_reads, wref = wide_setup
    assert TP.choose_sharded_engine(wide_index, ip=2) == "sharded-mega-wide"
    p, c, name = TP.query_batch_sharded_auto(wide_index, wide_reads,
                                             mesh=tmesh(4, 2))
    assert name == "sharded-mega-wide"
    assert_same((p, c), wref)

    _, narrow_index, reads = setup
    name = TP.choose_sharded_engine(narrow_index, ip=2, device="cpu")
    assert name == JP.choose_sharded_engine(narrow_index, ip=2)
    assert name in ("sharded-pos", "sharded-mega")
    got = TP.query_batch_sharded_auto(narrow_index, reads, mesh=tmesh(4, 2))
    want = JP.query_batch_sharded_auto(narrow_index, reads,
                                       mesh=JP.make_mesh(4, 2))
    assert got[2] == want[2] == name
    assert_same(got[:2], want[:2])
    # a budget too small for any table: the ladder steps down as JAX's
    for budget in (1, 10 << 30):
        assert (TP.choose_sharded_engine(narrow_index, 2, budget)
                == JP.choose_sharded_engine(narrow_index, 2, budget))


def test_router_budget_per_card(setup, monkeypatch):
    """The card's budget is split over the shards one device holds, so a
    repeated device list lowers the k the router gives the pos engine; a
    given budget is per shard, as JAX's."""
    from colbwt_tpu_torch.parallel import router as TR

    _, index, reads = setup
    assert [tmesh(dp, ip).shards_per_device()
            for dp, ip in ((2, 1), (1, 2), (2, 2), (1, 8))] == [1, 2, 2, 8]
    A = index.sigma + 1
    card = (A ** 2) * (-(-index.n // 2)) * 8  # one k = 2 block at ip = 2
    assert TSP.choose_k_sharded(index, 2, card) == 2
    assert TSP.choose_k_sharded(index, 2, card // 2) == 1
    monkeypatch.setattr(TR, "resolve_pos_budget", lambda cfg, dev=None: card)
    seen = []
    run = TSP.query_batch_sharded_pos

    def spy(*a, k=None, **kw):
        seen.append(k)
        return run(*a, k=k, **kw)

    monkeypatch.setattr(TSP, "query_batch_sharded_pos", spy)
    want = JP.query_batch_sharded_auto(index, reads, mesh=JP.make_mesh(1, 2))
    for budget, k in ((None, 1), (card, 2)):
        got = TP.query_batch_sharded_auto(index, reads, mesh=tmesh(1, 2),
                                          hbm_budget_bytes=budget)
        assert got[2] == want[2] == "sharded-pos" and seen[-1] == k
        assert_same(got[:2], want[:2])


def _shard_table(st, ip):
    return np.concatenate([st["mega"][("cpu", i)].numpy() for i in range(ip)])


def test_shard_mega_wide_slices_match_full_table(wide_setup):
    """Each shard's slice, filled on its device from K6b blocks, equals the
    full table's rows (the port's and JAX's host table), for every ip split;
    a JAX-built host table handed over as `mega_host` places the same rows
    and answers the same."""
    index, reads, ref = wide_setup
    full = TW.build_mega_table_wide(index, compact=False,
                                    device="cpu")["mega"].numpy()
    host = JW.build_mega_rows_wide_host(index)
    np.testing.assert_array_equal(full, host)
    for dp, ip in ((2, 4), (1, 8), (8, 1), (1, 3)):
        mesh = tmesh(dp, ip)
        st = TSW.shard_mega_wide(index, mesh)
        got = _shard_table(st, ip)
        np.testing.assert_array_equal(got[:full.shape[0]], full)
        assert not got[full.shape[0]:].any()  # ip padding rows stay zero
        st_host = TSW.shard_mega_wide(index, mesh, mega_host=host)
        np.testing.assert_array_equal(_shard_table(st_host, ip), got)
    assert_same(TSW.query_batch_sharded_mega_wide(
        index, reads, mesh=tmesh(1, 8), st=TSW.shard_mega_wide(
            index, tmesh(1, 8), mega_host=host)), ref)


def test_wide_slices_cross_char_blocks():
    """A dense index (r in the tens of thousands) where every shard's slice
    spans char-block edges: the slices equal the full table, and queries
    equal the oracle."""
    rng = np.random.default_rng(0xD15C)
    doc = rng.choice(np.frombuffer(b"ACGT", np.uint8), 30_000).tobytes()
    tbl, _ = build_index([doc, doc[:17_000] + doc[19_000:]])
    index = ColPmlIndex.build(tbl, ff_bound=2, wide=True)
    assert index.wide and index.r > 20_000
    ip = 4
    mesh = tmesh(2, ip)
    rows = (index.sigma + 1) * index.r
    assert rows // ip > index.r  # each slice crosses >= 1 char-block edge
    st = TSW.shard_mega_wide(index, mesh)
    got = _shard_table(st, ip)
    np.testing.assert_array_equal(got[:rows],
                                  JW.build_mega_rows_wide_host(index))
    assert not got[rows:].any()

    reads = [doc[int(rng.integers(0, 29_000)):][:60] for _ in range(16)]
    p, c = TSW.query_batch_sharded_mega_wide(index, reads, mesh=mesh, st=st)
    for j, rd in enumerate(reads):
        p_ref, c_ref = O.query_pml_oracle(tbl, rd)
        np.testing.assert_array_equal(p[j], p_ref, err_msg=f"read {j}")
        np.testing.assert_array_equal(c[j], c_ref, err_msg=f"read {j}")
