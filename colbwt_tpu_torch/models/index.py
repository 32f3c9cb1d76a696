"""ColPmlIndex — the queryable index as structure-of-arrays; the port's
copy of colbwt_tpu/models/index.py.

The reference packs each run into an 18-byte bit-field row (col_thr: char 8b +
idx 40b + interval 32b + offset 16b + col_id 8b + threshold 40b,
include/col_bwt.hpp:81-115) and scans runs linearly for pred/succ lookups
(include/ds/LF_table.hpp:271-298).  The device-first layout instead is:

- one int32 array per field (SoA) so each query step is a handful of batched
  (B,)-shaped gathers from device memory instead of strided struct reads;
- a dense remapped alphabet (DNA collections have ~6 symbols) so per-char
  structures are small;
- precomputed per-char pred/succ jump tables replacing the linear scans with
  O(1) gathers — same results (SURVEY §7 layer 4);
- thresholds/idx as int32 while n < 2**31, int64 beyond (the wide layout).

Serialization is plain .npz of named arrays, the same file as the JAX
package's: either package's `ColPmlIndex.load` reads the other's `save`.
`ColPmlIndex.from_arrays` carries an index across from the JAX package's
fields (numpy arrays), as `LFTableArrays.from_arrays` and
`FLTableArrays.from_arrays` do for the move tables.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from colbwt_tpu_torch.ops.oracle import LFTableArrays, from_fields

INT32_MAX = 2**31 - 1
MAX_WIDE_RUN_LEN = 2**29  # run-length cap when n >= 2**31 (one int32 limb)

# sentinel conventions for jump tables
NO_PRED = -1  # pred_jump value when no c-run at or before


@dataclasses.dataclass
class ColPmlIndex:
    """Device-ready col-pml move structure.

    All arrays int32.  ``char`` holds dense alphabet ids; ``alphabet`` maps
    dense id -> original byte; ``char_map`` maps byte -> dense id (or sigma
    for absent bytes, which row of the jump tables holds only sentinels).
    """

    char: np.ndarray            # (r,) dense char id per run
    idx: np.ndarray             # (r,) rank-coordinate start per run
    length: np.ndarray          # (r,)
    dest_interval: np.ndarray   # (r,) LF destination run
    dest_offset: np.ndarray     # (r,) LF destination offset
    col_id: np.ndarray          # (r,)
    threshold: np.ndarray       # (r,)
    pred_jump: np.ndarray       # (sigma+1, r): largest run <= i with char c, else -1
    succ_jump: np.ndarray       # (sigma+1, r): smallest run >= i with char c, else r
    alphabet: np.ndarray        # (sigma,) byte value of each dense id
    char_map: np.ndarray        # (256,) byte -> dense id (sigma if absent)
    n: int
    r: int
    bwt_r: int
    ff_bound: int = 0  # max LF-image run span if the table was split (0 = unbounded)
    wide_override: bool | None = None  # force the wide layout regardless of n

    @property
    def sigma(self) -> int:
        return int(self.alphabet.size)

    @property
    def wide(self) -> bool:
        """True when n >= 2**31: idx/threshold are int64 and querying must go
        through ops.query_mega_wide (split-word positions on device).

        ``wide_override`` forces the wide layout on a small index — the limb
        arithmetic is exact at any n, so pipelines (and tests) can exercise
        the full wide path end-to-end without a 2**31-character build."""
        if self.wide_override is not None:
            return self.wide_override
        return self.n > INT32_MAX

    # ------------------------------------------------------------------
    @classmethod
    def from_table(cls, tbl: LFTableArrays, ff_bound: int = 0,
                   wide: bool | None = None) -> "ColPmlIndex":
        """Build from the oracle's LF table (with col_id + threshold).

        Pass ff_bound=K when `tbl` was produced by ops.run_split with bound K
        (enables the statically-unrolled LF fast-forward in the engines).

        When n >= 2**31 (HPRC-scale, reference budget n < 2**40 at
        include/ds/LF_table.hpp:36-39) the position-valued fields idx and
        threshold stay int64 host-side (`.wide` becomes True) and querying
        goes through ops.query_mega_wide, which carries positions as two
        int32 limbs on device; run-valued fields remain int32 (r < 2**31,
        matching the reference's RUN_BYTES=4).  ``wide=True`` forces the
        wide layout at any n."""
        r = tbl.r
        wide_override = wide
        wide = tbl.n > INT32_MAX if wide is None else wide
        pos_dtype = np.int64 if wide else np.int32
        heads = np.asarray(tbl.char, dtype=np.uint8)
        alphabet = np.unique(heads)
        char_map = np.full(256, alphabet.size, dtype=np.int32)
        char_map[alphabet] = np.arange(alphabet.size, dtype=np.int32)
        dense = char_map[heads]

        sigma = alphabet.size
        pred = np.full((sigma + 1, r), NO_PRED, dtype=np.int32)
        succ = np.full((sigma + 1, r), r, dtype=np.int32)
        rows = np.arange(r, dtype=np.int32)
        for ci in range(sigma):
            is_c = dense == ci
            # pred: last c-run at or before each row (running maximum)
            p = np.where(is_c, rows, NO_PRED)
            np.maximum.accumulate(p, out=p)
            pred[ci] = p
            # succ: first c-run at or after each row (reversed running minimum)
            s = np.where(is_c, rows, r)
            succ[ci] = np.minimum.accumulate(s[::-1])[::-1]

        col_id = (np.zeros(r, dtype=np.int32) if tbl.col_id is None
                  else np.asarray(tbl.col_id, dtype=np.int32))
        threshold = (np.zeros(r, dtype=pos_dtype) if tbl.threshold is None
                     else np.asarray(tbl.threshold, dtype=pos_dtype))
        if wide and int(np.asarray(tbl.length).max(initial=0)) > MAX_WIDE_RUN_LEN:
            raise ValueError(
                "wide tables need run lengths <= 2**29 so offsets fit one "
                "int32 limb; build with ColPmlIndex.build (applies "
                "split_runs_max_len)")
        return cls(
            char=dense.astype(np.int32),
            idx=np.asarray(tbl.idx, dtype=pos_dtype),
            length=np.asarray(tbl.length, dtype=np.int32),
            dest_interval=np.asarray(tbl.dest_interval, dtype=np.int32),
            dest_offset=np.asarray(tbl.dest_offset, dtype=np.int32),
            col_id=col_id, threshold=threshold,
            pred_jump=pred, succ_jump=succ,
            alphabet=alphabet, char_map=char_map,
            n=int(tbl.n), r=int(r),
            bwt_r=int(tbl.bwt_r) if tbl.bwt_r is not None else int(r),
            ff_bound=int(ff_bound),
            wide_override=wide_override,
        )

    @classmethod
    def from_arrays(cls, fields: dict) -> "ColPmlIndex":
        """The index from a dict of its fields, such as ``vars()`` of the
        JAX package's ColPmlIndex (arrays of any array type become numpy)."""
        return from_fields(cls, fields)

    @classmethod
    def build(cls, tbl: LFTableArrays, ff_bound: int = 4,
              wide: bool | None = None) -> "ColPmlIndex":
        """from_table + run splitting so the LF fast-forward is statically
        bounded (ops.run_split; Movi-style splitting [inferred]).

        The recorded bound is the *achieved* maximum LF-image span, which can
        exceed the requested ff_bound on self-overlapping repeat runs — the
        engines unroll to whatever is recorded.  Wide tables (n >= 2**31, or
        ``wide=True``) additionally get their run lengths capped so offsets
        fit one int32 limb."""
        from colbwt_tpu_torch.ops.run_split import (max_ff_span,
                                              split_runs_bounded_ff,
                                              split_runs_max_len)
        if tbl.n > INT32_MAX or wide:
            tbl = split_runs_max_len(tbl, MAX_WIDE_RUN_LEN)
        split = split_runs_bounded_ff(tbl, ff_bound)
        achieved = max(ff_bound, max_ff_span(split))
        return cls.from_table(split, ff_bound=achieved, wide=wide)

    # ------------------------------------------------------------------
    def encode_patterns(self, patterns: list[bytes], max_len: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Right-align patterns into a (B, M) dense-id matrix + (B,) lengths.

        Right alignment (left padding) lets every lane start its backward scan
        at the same step: step i of the batched engine processes column
        M-1-i, which is pattern position m-1-i for every read (SURVEY §5.7:
        the batch is the parallel axis, reads advance in lockstep).
        """
        B = len(patterns)
        M = max_len if max_len is not None else max((len(p) for p in patterns), default=1)
        out = np.zeros((B, M), dtype=np.int32)
        lens = np.zeros(B, dtype=np.int32)
        sigma = self.sigma
        for b, p in enumerate(patterns):
            arr = np.frombuffer(p, dtype=np.uint8)
            if arr.size > M:
                raise ValueError(f"pattern {b} length {arr.size} > max_len {M}")
            enc = self.char_map[arr]
            out[b, M - arr.size:] = enc
            lens[b] = arr.size
        assert out.max(initial=0) <= sigma
        return out, lens

    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path,
            char=self.char, idx=self.idx, length=self.length,
            dest_interval=self.dest_interval, dest_offset=self.dest_offset,
            col_id=self.col_id, threshold=self.threshold,
            pred_jump=self.pred_jump, succ_jump=self.succ_jump,
            alphabet=self.alphabet, char_map=self.char_map,
            meta=np.array([self.n, self.r, self.bwt_r, self.ff_bound,
                           -1 if self.wide_override is None
                           else int(self.wide_override)],
                          dtype=np.int64),
        )

    @classmethod
    def load(cls, path: str | Path) -> "ColPmlIndex":
        z = np.load(path if str(path).endswith(".npz") else f"{path}.npz")
        meta = [int(v) for v in z["meta"]]
        n, r, bwt_r = meta[:3]
        ff = meta[3] if len(meta) > 3 else 0
        wo = meta[4] if len(meta) > 4 else -1
        return cls(
            char=z["char"], idx=z["idx"], length=z["length"],
            dest_interval=z["dest_interval"], dest_offset=z["dest_offset"],
            col_id=z["col_id"], threshold=z["threshold"],
            pred_jump=z["pred_jump"], succ_jump=z["succ_jump"],
            alphabet=z["alphabet"], char_map=z["char_map"],
            n=n, r=r, bwt_r=bwt_r, ff_bound=ff,
            wide_override=None if wo < 0 else bool(wo),
        )

    def nbytes(self) -> int:
        return sum(a.nbytes for a in (
            self.char, self.idx, self.length, self.dest_interval,
            self.dest_offset, self.col_id, self.threshold,
            self.pred_jump, self.succ_jump))

    def stats(self) -> dict:
        """Structural stats, the bwt_stats/mem_stats equivalent
        (include/ds/LF_table.hpp:305-320, include/col_bwt.hpp:336-350)."""
        import math

        col_runs = int((self.col_id > 0).sum())
        col_chars = int(self.length[self.col_id > 0].sum())
        return {
            "n": self.n,
            "r": self.r,
            "bwt_r": self.bwt_r,
            "n_over_r": self.n / max(self.r, 1),
            "log2_r": math.log2(max(self.r, 1)),
            "sigma": self.sigma,
            "ff_bound": self.ff_bound,
            "col_runs": col_runs,
            "col_chars": col_chars,
            "col_char_fraction": col_chars / max(self.n, 1),
            "bytes": self.nbytes(),
            "bytes_per_run": self.nbytes() / max(self.r, 1),
        }
