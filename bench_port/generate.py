"""The general generators: a configuration's collection and a traffic mix's
reads, both from the run's seed and the parameters in their JSON files.

Collections (a configuration's "generator"):

- "haplotypes": one random base of `doc_len` bp and `docs` copies of it,
  each with `substitutions_per_doc` substitutions at positions drawn with
  replacement, a random base each (scripts/validate_config4.py's arithmetic,
  as chip_smoke.py `config4_docs` copies it);
- "hotspot_genomes": one random base, `hotspots` sites drawn without
  replacement, and `docs` copies, each with `substitutions_per_doc`
  substitutions at sites drawn without replacement from the hotspots
  (scripts/validate_config3.py's arithmetic, chip_smoke.py `config3_docs`).

Reads (a traffic mix): a list of components taken in turn, each `count`
reads a job of a `fixed` length, cut from a uniformly drawn document at a
uniformly drawn start, then given up to `uniform_max` substitutions (as
validate_config4.py draws them) and `n_inserted` N bases at random places.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream (0: collection, 1: reads, 2: warm-up
    reads, ...) of a run's seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def collection(cfg: dict, seed: int) -> list[np.ndarray]:
    """The configuration's documents (uint8 arrays over ACGT)."""
    rng = rng_for(seed, 0)
    kind = cfg["generator"]
    D, L, subs = cfg["docs"], cfg["doc_len"], cfg["substitutions_per_doc"]
    base = rng.choice(ACGT, L)
    if kind == "haplotypes":
        docs = np.broadcast_to(base, (D, L)).copy()
        pos = rng.integers(0, L, (D, subs))
        docs[np.arange(D)[:, None], pos] = rng.choice(ACGT, (D, subs))
    elif kind == "hotspot_genomes":
        sites = rng.choice(L, cfg["hotspots"], replace=False)
        docs = np.broadcast_to(base, (D, L)).copy()
        pick = np.argsort(rng.random((D, sites.size)), axis=1)[:, :subs]
        docs[np.arange(D)[:, None], sites[pick]] = rng.choice(ACGT, (D, subs))
    else:
        raise ValueError(f"unknown generator {kind!r}")
    return list(docs)


def write_collection(docs: list[np.ndarray], work: Path) -> Path:
    """One FASTA file a document and a file list of them; returns the
    list's path."""
    work.mkdir(parents=True, exist_ok=True)
    files = []
    for i, d in enumerate(docs):
        f = work / f"doc{i}.fa"
        f.write_bytes(b">doc%d\n" % i + d.tobytes() + b"\n")
        files.append(f)
    listing = work / "docs.txt"
    listing.write_text("".join(f"{f}\n" for f in files))
    return listing


@dataclass
class Reads:
    """A job's reads in file order: names, a left-aligned (B, W) uint8
    matrix and the lengths."""

    names: list[str]
    seqs: np.ndarray
    lens: np.ndarray

    @property
    def bases(self) -> int:
        return int(self.lens.sum())

    def write_fasta(self, path: Path) -> int:
        """Write the reads as FASTA, one line a sequence; returns bytes."""
        rows = [b">%s\n%s\n" % (nm.encode(), self.seqs[i, :m].tobytes())
                for i, (nm, m) in enumerate(zip(self.names,
                                                self.lens.tolist()))]
        data = b"".join(rows)
        path.write_bytes(data)
        return len(data)


def _component(docs: list[np.ndarray], comp: dict, count: int,
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(left-aligned (count, W) uint8 matrix, lengths) of one component."""
    m = int(comp["length"]["fixed"])
    n_ins = int(comp.get("n_inserted", 0))
    doc_len = min(d.size for d in docs)
    which = rng.integers(0, len(docs), count)
    start = rng.integers(0, doc_len - m + 1, count)
    k = rng.integers(0, comp["substitutions"]["uniform_max"] + 1, count)
    mat = np.stack(docs)[which[:, None], start[:, None] + np.arange(m)]
    if k.max() > 0:
        K = int(k.max())
        cols = rng.integers(0, m, (count, K))
        bases = rng.choice(ACGT, (count, K))
        for j in range(K):
            rows = np.flatnonzero(j < k)
            mat[rows, cols[rows, j]] = bases[rows, j]
    for _ in range(n_ins):
        at = rng.integers(0, m + 1, count)
        c = np.arange(m + 1)
        src = mat[np.arange(count)[:, None], np.clip(c - (c > at[:, None]),
                                                     0, m - 1)]
        mat = np.where(c == at[:, None], np.uint8(ord("N")), src)
        m += 1
    return mat.astype(np.uint8), np.full(count, m, dtype=np.int64)


def reads(docs: list[np.ndarray], traffic: dict,
          rng: np.random.Generator) -> Reads:
    """One job's reads of the traffic mix."""
    names: list[str] = []
    mats, lens = [], []
    for comp in traffic["components"]:
        m, ln = _component(docs, comp, comp["count"], rng)
        mats.append(m)
        lens.append(ln)
        names += [f"{comp['name']}{i}" for i in range(comp["count"])]
    W = max(m.shape[1] for m in mats)
    mat = np.concatenate([np.pad(m, ((0, 0), (0, W - m.shape[1])))
                          for m in mats])
    return Reads(names, mat, np.concatenate(lens))
