"""The reference equals the program's CPU path (the port's build and
streamed query with device "cpu") on tiny collections of both
configurations, record for record."""

import numpy as np
import pytest

from bench_port import generate as G
from bench_port import harness as H
from bench_port import judge as J
from bench_port import reference as R


@pytest.mark.parametrize("cell", ["chr21_hap8.short", "sarscov2_10k.short"])
def test_reference_equals_the_port_on_the_cpu(tiny, tmp_path, cell):
    from colbwt_tpu_torch.pipeline.build import build_pipeline
    from colbwt_tpu_torch.pipeline.stream import query_stream

    w = tiny.cell(cell)
    cfg = tiny.config(w["config"])
    docs = G.collection(cfg, 2**33 + 5)
    listing = G.write_collection(docs, tmp_path / "docs")
    bcfg, qcfg = H._configs(cfg, sum(d.size + 1 for d in docs))
    prefix = str(tmp_path / "idx")
    build_pipeline([], prefix, bcfg, filelist=str(listing), device="cpu")
    reads = G.reads(docs, tiny.traffic(w["traffic"]), G.rng_for(9, 1))
    fa = tmp_path / "reads.fa"
    reads.write_fasta(fa)
    query_stream(prefix, str(fa), qcfg, device="cpu")
    pml, cid, counts = R.records(docs, cfg["build"], reads.seqs, reads.lens,
                                 "cpu")
    assert counts["mums"] > 0 and counts["marks"] > 0
    assert (cid > 0).any() and (pml > 20).any()
    offs, _ = J.record_layout(reads.names, reads.lens)
    for ext, vals in (("pml", pml), ("cid", cid)):
        got = J.read_file(tmp_path / f"reads.fa.split.{ext}.bin")
        want = J.expected_file(reads.names, vals, reads.lens)
        assert J.wrong_records(got, want, offs) == 0


def test_stages_equal_the_specification():
    """Each stage against the port's host specification (ops/oracle.py) on
    small haplotype and many-document collections."""
    from colbwt_tpu_torch.ops import oracle as O

    for trial in range(8):
        rng = np.random.default_rng(trial)
        N = int(rng.integers(2, 90))
        L = int(rng.integers(60, 300))
        base = rng.choice(G.ACGT, L)
        docs = []
        for _ in range(N):
            a = base.copy()
            a[rng.integers(0, L, 3)] = rng.choice(G.ACGT, 3)
            docs.append(a)
        text, ranks, doc_ids = O.concat_collection([d.tobytes()
                                                    for d in docs])
        sa = O.suffix_array(ranks)
        lcp = O.lcp_kasai(ranks, sa)
        heads, lens = O.rle(O.bwt_from_sa(text, sa))
        ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, N, 8)
        fl = O.build_fl_table(heads, lens)
        mpos, mids, mhts = O.col_split_oracle(fl, ml, mp, N, 4, "tunnels", 8)
        bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads,
                                           fl.n)
        tbl = O.build_col_pml(heads, lens, bits, ids,
                              O.compute_thresholds(heads, lens, lcp))
        ref = R.build(docs, 8, 4)
        assert ref.counts["mums"] == ml.size
        assert ref.counts["marks"] == mpos.size
        assert np.array_equal(ref.split_pos.numpy(), bits)
        assert np.array_equal(ref.split_ids.numpy(), ids)
        reads = [docs[int(rng.integers(0, N))][s:s + 40].copy()
                 for s in rng.integers(0, L - 40, 20)]
        reads[0][5] = ord("N")
        pml, cid = R.query(ref, np.stack(reads), np.full(20, 40))
        for i, rd in enumerate(reads):
            ep, ec = O.query_pml_oracle(tbl, rd.tobytes())
            assert np.array_equal(pml[i], ep) and np.array_equal(cid[i], ec)
