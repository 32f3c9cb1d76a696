"""The generators: the same seed gives the same inputs, another seed
others, and the sizes are the files' own."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench_port import generate as G

ROOT = Path(__file__).resolve().parent.parent
BIG = 2**31 + 977  # seeds may pass 32 bits


def _cfg(name, **cut):
    cfg = json.loads((ROOT / f"bench_port/configs/{name}.json").read_text())
    cfg.update(cut)
    return cfg


@pytest.mark.parametrize("name,cut", [
    ("chr21_hap8", {"doc_len": 5000}),
    ("sarscov2_10k", {"docs": 500, "doc_len": 400, "hotspots": 10})])
def test_collection_per_seed(name, cut):
    cfg = _cfg(name, **cut)
    a = G.collection(cfg, BIG)
    b = G.collection(cfg, BIG)
    c = G.collection(cfg, BIG + 1)
    assert len(a) == cfg["docs"]
    assert all(d.size == cfg["doc_len"] and d.dtype == np.uint8 for d in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert set(np.unique(np.concatenate(a)).tolist()) <= set(b"ACGT")
    # each document differs from the others' common base in few places
    base = np.array([np.bincount(col, minlength=256).argmax()
                     for col in np.stack(a).T], dtype=np.uint8)
    most = cfg["substitutions_per_doc"]
    assert max(int((d != base).sum()) for d in a) <= most


def test_hotspots_only():
    cfg = _cfg("sarscov2_10k", docs=400, doc_len=300, hotspots=6,
               substitutions_per_doc=2)
    docs = np.stack(G.collection(cfg, 5))
    varying = np.flatnonzero((docs != docs[0]).any(axis=0))
    assert varying.size <= 6


def test_reads_as_the_mix_says(tmp_path):
    tr = json.loads((ROOT / "bench_port/traffic/short150.json").read_text())
    cut = {"q": 2611, "n": 10}
    for comp in tr["components"]:
        comp["count"] = cut[comp["name"]]
    docs = G.collection(_cfg("chr21_hap8", doc_len=20000), BIG)
    r = G.reads(docs, tr, G.rng_for(BIG, 1))
    q = [i for i, nm in enumerate(r.names) if nm.startswith("q")]
    n = [i for i, nm in enumerate(r.names) if nm.startswith("n")]
    assert len(q) == 2611 and len(n) == 10
    assert (r.lens[q] == 150).all() and (r.lens[n] == 151).all()
    assert ((r.seqs[q] == ord("N")).sum(axis=1) == 0).all()
    assert ((r.seqs[n] == ord("N")).sum(axis=1) == 1).all()
    assert r.names[:len(q)] == [f"q{i}" for i in range(len(q))]
    again = G.reads(docs, tr, G.rng_for(BIG, 1))
    assert np.array_equal(r.seqs, again.seqs)
    size = sum(len(nm) + 3 + int(m) for nm, m in zip(r.names, r.lens))
    assert r.write_fasta(tmp_path / "r.fa") == size
    assert (tmp_path / "r.fa").stat().st_size == size
    # every read is a window of a document with at most 3 substitutions
    text = np.stack(docs)
    hits = 0
    for i in q[:40]:
        read = r.seqs[i, :150]
        for d in text:
            win = np.lib.stride_tricks.sliding_window_view(d, 150)
            if ((win != read).sum(axis=1) <= 3).any():
                hits += 1
                break
    assert hits == 40
