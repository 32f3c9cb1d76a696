"""The port's streaming query against the JAX package's: byte-equal output
files for every engine the ladder can stream with, over several batches
with long reads in between (as tests/test_stream.py:59 mixes them).

Both packages query the same run-split index, built once by the JAX
package; the port runs its plain PyTorch path on the CPU.
"""

import numpy as np
import pytest

from colbwt_tpu.io.fasta import FastaRecord, write_fasta
from colbwt_tpu.pipeline import build_pipeline as jax_build
from colbwt_tpu.pipeline import query_stream as jax_stream
from colbwt_tpu.utils.config import ColBwtConfig
from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary
from colbwt_tpu_torch.pipeline import query_pipeline, query_stream
from tests.conftest import random_docs


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A run-split index (so the mega and fused engines can serve it) and
    250 reads with three long ones and two with an N mixed in."""
    rng = np.random.default_rng(0x57E4)
    tmp = tmp_path_factory.mktemp("torch_stream")
    base = bytes(rng.choice(list(b"ACGT"), 600).astype("uint8"))
    docs = random_docs(rng, 2, mutate_from=base)
    for i, d in enumerate(docs):
        write_fasta(tmp / f"s{i}.fa", [FastaRecord(f"s{i}", d)])
    jax_build([str(tmp / "s0.fa"), str(tmp / "s1.fa")], str(tmp / "idx"),
              ColBwtConfig(min_mum=15, run_split="always"))
    reads = []
    for i in range(250):
        d = docs[int(rng.integers(0, 2))]
        s = int(rng.integers(0, len(d) - 80))
        seq = bytearray(d[s:s + int(rng.integers(20, 80))])
        if i % 97 == 5:
            seq[int(rng.integers(0, len(seq)))] = ord("N")
        reads.append(FastaRecord(f"r{i}", bytes(seq)))
    for j in range(3):
        reads.insert(int(rng.integers(0, len(reads))),
                     FastaRecord(f"L{j}", docs[j % 2][j * 20:j * 20 + 540]))
    write_fasta(tmp / "reads.fa", reads)
    return tmp, reads


def _cfg(engine: str) -> ColBwtConfig:
    return ColBwtConfig(engine=engine, batch_size=32, long_read_len=128,
                        long_read_chunk=64, table_cache="off")


@pytest.mark.parametrize("engine,name", [
    ("pos", "pos(k="), ("xla", "xla"), ("mega", "mega"),
    ("fused", "fused")])
def test_stream_files_match_jax(built, engine, name):
    tmp, reads = built
    outs = {}
    for pkg, stream in (("jax", jax_stream), ("torch", query_stream)):
        pat = tmp / f"{engine}.{pkg}.fa"
        pat.write_bytes((tmp / "reads.fa").read_bytes())
        kw = {"device": "cpu"} if pkg == "torch" else {}
        stats = stream(str(tmp / "idx"), str(pat), _cfg(engine), **kw)
        assert stats["reads"] == len(reads)
        outs[pkg] = [(tmp / f"{pat.name}.split.{x}.bin").read_bytes()
                     for x in ("pml", "cid")]
    assert stats["engine"].startswith(name)
    assert outs["torch"] == outs["jax"]
    names, _ = read_pml_cid_binary(tmp / f"{engine}.torch.fa.split.pml.bin")
    assert names == [r.name for r in reads]  # strict input order


@pytest.mark.parametrize("engine", ["pos", "fused"])
def test_stream_matches_one_shot(built, engine):
    """The port's stream and its one-shot query write the same files."""
    tmp, _ = built
    files = {}
    for how, run in (("stream", query_stream), ("one", query_pipeline)):
        pat = tmp / f"{engine}.{how}.fa"
        pat.write_bytes((tmp / "reads.fa").read_bytes())
        run(str(tmp / "idx"), str(pat), _cfg(engine), device="cpu")
        files[how] = [(tmp / f"{pat.name}.split.{x}.bin").read_bytes()
                      for x in ("pml", "cid")]
    assert files["stream"] == files["one"]


def _mixed_batch(tmp, docs_reads):
    """One batch of 120 reads whose names change length at 10 and 100,
    whose lengths change in runs and singly, with N reads among them."""
    rng = np.random.default_rng(0x3B7C)
    src = [r.seq for r in docs_reads if len(r.seq) >= 70]
    reads = []
    for i in range(5, 125):
        m = 60 if i < 70 else (61 if i % 9 else 40 + i % 13)
        seq = bytearray(src[i % len(src)][:m])
        if i % 17 == 4:
            seq[int(rng.integers(0, m))] = ord("N")
        reads.append(FastaRecord(f"q{i}", bytes(seq)))
    write_fasta(tmp / "mixed.fa", reads)
    return reads


@pytest.mark.parametrize("engine", ["pos", "xla"])
def test_stream_mixed_batch_matches_jax(built, engine):
    """Records of several shapes in one batch, N reads spliced in from the
    fallback: the port's files equal the JAX package's, one block a run of
    one (name length, read length)."""
    tmp, reads = built
    mixed = _mixed_batch(tmp, reads)
    cfg = ColBwtConfig(engine=engine, batch_size=256, table_cache="off")
    outs = {}
    for pkg, stream in (("jax", jax_stream), ("torch", query_stream)):
        pat = tmp / f"mixed.{engine}.{pkg}.fa"
        pat.write_bytes((tmp / "mixed.fa").read_bytes())
        kw = {"device": "cpu"} if pkg == "torch" else {}
        stats = stream(str(tmp / "idx"), str(pat), cfg, **kw)
        outs[pkg] = [(tmp / f"{pat.name}.split.{x}.bin").read_bytes()
                     for x in ("pml", "cid")]
    assert outs["torch"] == outs["jax"]
    shapes = [(len(r.name), len(r.seq)) for r in mixed]
    runs = 1 + sum(a != b for a, b in zip(shapes, shapes[1:]))
    assert stats["counters"]["batches"] == 1
    assert stats["counters"]["write_blocks"] == runs
    if engine == "pos":
        assert stats["counters"]["fallback_reads"] > 0


def test_stream_batch_path_writes_no_record_at_a_time(built, monkeypatch):
    """The short-read batches go through the batch form of the writer; the
    long-read path still writes record by record."""
    from colbwt_tpu_torch.io import pml_out

    calls = []
    real = pml_out._record_bytes

    def spy(name, arr):
        calls.append(name)
        return real(name, arr)

    monkeypatch.setattr(pml_out, "_record_bytes", spy)
    tmp, reads = built
    for name, long_reads in (("short", False), ("long", True)):
        pat = tmp / f"spy.{name}.fa"
        pat.write_bytes((tmp / "reads.fa").read_bytes())
        cfg = _cfg("pos") if long_reads else ColBwtConfig(
            engine="pos", batch_size=32, table_cache="off")
        stats = query_stream(str(tmp / "idx"), str(pat), cfg, device="cpu")
        assert stats["reads"] == len(reads)
        if long_reads:
            assert sorted(calls) == sorted(
                2 * [r.name for r in reads if len(r.seq) > 128])
        else:
            assert calls == []
