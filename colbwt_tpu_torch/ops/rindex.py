"""Rank/select RLBWT (the r_index representation) — the port's copy of
colbwt_tpu/ops/rindex.py, an alternative to the move tables.

The reference compiles (but never drives) an r-index lifted from
maxrossi91/r-index: a run-length BWT with rank/select support, LF by rank,
FL by select, and an F-column array (include/ds/r_index.hpp:34-216).  For
capability parity this module rebuilds that representation array-shaped:
per-char sorted run arrays + prefix sums, so rank and select are batched
searchsorted calls instead of wavelet-tree walks — O(log r_c) per query,
vectorizable over whole batches.

This stays the *alternative* representation (the reference never calls its
r_index from any driver; SURVEY §2.1): the query hot path uses the move
tables / positional automaton.  Backward-search count() is included — the
one capability the rank/select layout offers beyond the move table.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from colbwt_tpu_torch.ops.oracle import normalize_heads

ASCII = 256


@dataclasses.dataclass
class RankSelectRLBWT:
    """Run-length BWT with per-char rank/select (role of rle_string_sd,
    include/ds/r_index.hpp:29-33).

    run_char/run_start index the runs in L order; for each char c,
    c_runs[c] lists its run ids ascending and c_cum[c][j] is the number of
    c characters in its first j c-runs (exclusive prefix sum).
    """

    run_char: np.ndarray    # (r,) uint8
    run_start: np.ndarray   # (r,) int64, BWT position of each run head
    run_len: np.ndarray     # (r,) int64
    c_runs: dict            # char -> (r_c,) int64 run ids
    c_cum: dict             # char -> (r_c + 1,) int64 exclusive prefix sums
    n: int
    r: int

    @classmethod
    def from_rlbwt(cls, heads: np.ndarray, lens: np.ndarray) -> "RankSelectRLBWT":
        heads = normalize_heads(heads)
        lens = np.asarray(lens, dtype=np.int64)
        r = heads.size
        starts = np.zeros(r, dtype=np.int64)
        if r > 1:
            np.cumsum(lens[:-1], out=starts[1:])
        c_runs: dict = {}
        c_cum: dict = {}
        for c in np.unique(heads):
            ids = np.flatnonzero(heads == c).astype(np.int64)
            c_runs[int(c)] = ids
            c_cum[int(c)] = np.r_[0, np.cumsum(lens[ids])]
        return cls(run_char=heads, run_start=starts, run_len=lens,
                   c_runs=c_runs, c_cum=c_cum, n=int(lens.sum()), r=r)

    # -- primitives --------------------------------------------------------
    def run_of(self, i) -> np.ndarray:
        """Run containing BWT position(s) i."""
        return np.searchsorted(self.run_start, np.asarray(i), side="right") - 1

    def rank(self, i, c: int) -> np.ndarray:
        """Number of c in BWT[0, i) — rle_string rank semantics
        (include/ds/r_index.hpp:70-74).  Vectorized over i."""
        i = np.asarray(i, dtype=np.int64)
        if c not in self.c_runs:
            return np.zeros_like(i)
        ids = self.c_runs[c]
        cum = self.c_cum[c]
        run = self.run_of(np.maximum(i, 0))
        k = np.searchsorted(ids, run, side="left")
        full = cum[k]
        in_run = np.where((k < ids.size) & (ids[np.minimum(k, ids.size - 1)] == run),
                          i - self.run_start[run], 0)
        return np.where(i <= 0, 0, full + np.maximum(in_run, 0))

    def select(self, j, c: int) -> np.ndarray:
        """Position of the (j+1)-th c, j 0-based — rle_string select
        (include/ds/r_index.hpp:98-105).  Vectorized over j."""
        j = np.asarray(j, dtype=np.int64)
        ids = self.c_runs[c]
        cum = self.c_cum[c]
        k = np.searchsorted(cum, j, side="right") - 1
        return self.run_start[ids[k]] + (j - cum[k])

    def char_at(self, i) -> np.ndarray:
        return self.run_char[self.run_of(i)]


def build_rindex(heads: np.ndarray, lens: np.ndarray) -> "RIndex":
    return RIndex.from_rlbwt(heads, lens)


@dataclasses.dataclass
class RIndex:
    """r_index: rank/select RLBWT + F column (include/ds/r_index.hpp:34-216)."""

    bwt: RankSelectRLBWT
    F: np.ndarray               # (257,) int64: F[c] = count of chars < c
    terminator_position: int

    @classmethod
    def from_rlbwt(cls, heads: np.ndarray, lens: np.ndarray) -> "RIndex":
        bwt = RankSelectRLBWT.from_rlbwt(heads, lens)
        counts = np.zeros(ASCII + 1, dtype=np.int64)
        for c, cum in bwt.c_cum.items():
            counts[c] = cum[-1]
        F = np.r_[0, np.cumsum(counts[:-1])]
        term_runs = bwt.c_runs.get(1)
        term_pos = (int(bwt.run_start[term_runs[0]])
                    if term_runs is not None and term_runs.size else 0)
        return cls(bwt=bwt, F=F, terminator_position=term_pos)

    @property
    def n(self) -> int:
        return self.bwt.n

    # -- navigation (include/ds/r_index.hpp:63-119) ------------------------
    def LF(self, i, c: int | None = None) -> np.ndarray:
        """LF(i) = F[c] + rank_c(i); c defaults to BWT[i]."""
        i = np.asarray(i, dtype=np.int64)
        if c is not None:
            return self.F[c] + self.bwt.rank(i, c)
        run = self.bwt.run_of(i)
        out = np.empty_like(i)
        for cc in np.unique(self.bwt.run_char[run]):
            m = self.bwt.run_char[run] == cc
            out[m] = self.F[int(cc)] + self.bwt.rank(i[m], int(cc))
        return out

    def LF_range(self, lo: int, hi: int, c: int) -> tuple[int, int]:
        """Backward-search one char: inclusive range of c·w from range of w
        (include/ds/r_index.hpp:77-95); empty range = (1, 0)."""
        if c not in self.bwt.c_runs:  # char absent from the text
            return 1, 0
        before = int(self.bwt.rank(lo, c))
        inside = int(self.bwt.rank(hi + 1, c)) - before
        if inside == 0:
            return 1, 0
        l = int(self.F[c]) + before
        return l, l + inside - 1

    def f_at(self, i: int) -> int:
        """Character of F-column position i (include/ds/r_index.hpp:158-166)."""
        return int(np.searchsorted(self.F, i, side="right") - 1)

    def FL(self, i) -> np.ndarray:
        """Forward step by select (include/ds/r_index.hpp:99-105)."""
        i = np.asarray(i, dtype=np.int64)
        out = np.empty_like(i)
        # group by F-column char (F is a step function of i)
        cs = np.searchsorted(self.F, i, side="right") - 1
        for cc in np.unique(cs):
            m = cs == cc
            out[m] = self.bwt.select(i[m] - self.F[cc], int(cc))
        return out

    # -- capabilities -------------------------------------------------------
    def count(self, pattern: bytes) -> int:
        """Occurrences of pattern in the collection by backward search."""
        lo, hi = 0, self.n - 1
        for ch in reversed(pattern):
            lo, hi = self.LF_range(lo, hi, ch)
            if lo > hi:
                return 0
        return hi - lo + 1

    def invert(self) -> bytes:
        """Regenerate text by LF walking from position 0 until a terminator —
        the same round-trip oracle as LF_table::invert."""
        out = bytearray()
        i = 0
        while int(self.bwt.char_at(i)) > 1:
            out.append(int(self.bwt.char_at(i)))
            i = int(self.LF(np.array([i]))[0])
        return bytes(out)

    # -- persistence (npz of named arrays; SURVEY §5.4) ---------------------
    def save(self, path) -> None:
        np.savez_compressed(
            path, run_char=self.bwt.run_char, run_len=self.bwt.run_len,
            F=self.F,
            meta=np.array([self.terminator_position], dtype=np.int64))

    @classmethod
    def load(cls, path) -> "RIndex":
        z = np.load(path if str(path).endswith(".npz") else f"{path}.npz")
        return cls.from_rlbwt(z["run_char"], z["run_len"])
