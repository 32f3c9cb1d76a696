"""Single configuration object for build + query — the port's copy of
colbwt_tpu/utils/config.py, field for field, so a configuration means the
same to both packages.  Neither package's pipeline reads `dp` or `ip`: the
sharded query API takes its mesh shape as arguments (parallel/mesh.py).

The reference spreads its knobs over three tiers (compile-time macros in
include/common/common.hpp:45-68, getopt Args at :211-276, and the CLI argparse
in scripts/col-bwt.py:200-231).  Here they live in one dataclass consumed by
every stage.

Integer-width budget (reference: include/common/common.hpp:46-54 packs rows as
char:8 + idx:40 + interval:32 + offset:16 (+ col_id:8 + threshold:40)):
we keep the same *logical* limits (n < 2**40, r < 2**32, run length < 2**16
only for the packed on-disk export; in-memory device arrays are int32 when
n < 2**31 else int64) but lay the index out as structure-of-arrays, which is
what the device gather path wants.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from pathlib import Path


class SplitMode(str, enum.Enum):
    """How BWT runs are split by multi-MUM sub-runs.

    Mirrors Options::Mode of the reference (include/col_split.hpp:16-22).
    """

    ALL = "all"          # split at every col sub-run boundary
    TUNNELS = "tunnels"  # only while the FL image stays contiguous (tunneled)


@dataclasses.dataclass
class ColBwtConfig:
    # --- build knobs (scripts/col-bwt.py:205-223) ---
    mode: SplitMode = SplitMode.TUNNELS
    split_rate: int = 10          # -s / --sub-sample
    min_mum: int = 20             # -l / --min-mum
    rev_comp: bool = False        # -r
    keep_temp: bool = False       # --keep
    force: bool = False           # --force
    verbose: bool = False         # -v
    prewarm: bool = False         # build exit builds the query engine's
                                  # tables and saves them when the table
                                  # cache pays (pipeline/build.py
                                  # stage_prewarm); the CLI turns this on
                                  # (--no-prewarm to skip)

    # --- format budget (include/common/common.hpp:46-54) ---
    rw_bytes: int = 5             # RW_BYTES: on-disk width of n-scale ints
    id_bits: int = 8              # ID_BITS: col IDs binned into [1, 2**id_bits - 1]
    run_bytes: int = 4            # RUN_BYTES: on-disk width of r-scale ints
    len_bytes: int = 2            # LEN_BYTES: on-disk width of run lengths

    # --- query engine knobs (new; no reference counterpart) ---
    batch_size: int = 8192        # reads advanced in lockstep per device
    max_read_len: int = 256       # padded read length bucket
    engine: str = "auto"          # "pos" | "mega" | "fused" | "xla" | "auto"
    ff_bound: int = 2             # max LF fast-forward span after run splitting
                                  # (2 enables the 1-gather/step mega engine)
    pos_hbm_budget: int = 0       # HBM byte budget for the positional-
                                  # automaton tables ((sigma+1)**k * n * 8 B);
                                  # picks the largest k that fits.  0 = auto:
                                  # derive from the device's HBM
                                  # (utils/hbm.resolve_pos_budget; 10 GB when
                                  # the device is unknown)
    run_split: str = "auto"       # "auto" | "always" | "never": run splitting
                                  # only serves the mega/fused engines; "auto"
                                  # skips it when the positional-automaton
                                  # engine is viable (it needs no ff bound),
                                  # cutting minutes off multi-Mbp builds
    long_read_len: int = 1024     # reads longer than this stream in chunks
    long_read_chunk: int = 2048
    table_cache: str = "auto"     # "auto" | "force" | "off": persist built
                                  # engine tables (pos/mega/mega-wide) under
                                  # <index>.torch_tables/ (the port's own;
                                  # JAX's is <index>.tables/) and reload them
                                  # on later launches (pipeline/tables.py).
                                  # "auto" loads/saves only when the
                                  # projected load (file read and copy to
                                  # the card, measured) beats the build
                                  # time; "force" always does
    wide_n_limit: int = 2**31 - 1  # n above this uses the wide (two-limb)
                                  # index layout + ops.query_mega_wide; lower
                                  # it to force the wide path on small builds
                                  # (pipeline tests do)

    # --- construction scale knobs (new; the reference's PFP role) ---
    sa_mode: str = "auto"         # "auto" | "monolithic" | "chunked":
                                  # chunked construction (per-chunk SA-IS +
                                  # rank-based BWT merge + BWT-only LCP,
                                  # ops.construct_chunked) removes the
                                  # ~40 B/char monolithic SA working set;
                                  # "auto" switches over when n exceeds
                                  # sa_ram_chars
    sa_ram_chars: int = 0         # monolithic-SA character budget; 0 = auto
                                  # (60% of host MemTotal / 40 B per char)
    chunk_chars: int = 0          # chunk size for chunked construction;
                                  # 0 = auto (half the monolithic budget)

    # --- parallel knobs (new; reference is single-node: SURVEY §2.3) ---
    dp: int = 1                   # data-parallel (read-sharded) mesh axis
    ip: int = 1                   # index-parallel (interval-sharded) mesh axis

    _CHOICES = {
        "engine": ("auto", "pos", "mega", "fused", "xla"),
        "run_split": ("auto", "always", "never"),
        "table_cache": ("auto", "force", "off"),
        "sa_mode": ("auto", "monolithic", "chunked"),
    }

    def __post_init__(self) -> None:
        # enumerated string knobs fail loudly on typos ("on", "disable", …)
        # instead of silently behaving like "auto"
        for field, choices in self._CHOICES.items():
            v = getattr(self, field)
            if v not in choices:
                raise ValueError(
                    f"config.{field}={v!r} is not one of {choices}")

    @property
    def id_max(self) -> int:
        """Exclusive upper bound of col IDs (bit_max(ID_BITS),
        include/common/common.hpp:302-304)."""
        return 1 << self.id_bits

    def bin_id(self, ident: int) -> int:
        """Fold an id into [1, id_max - 1]; 0 stays 0 ("no id").

        Exact reference semantics: col_id_bin at
        include/common/common.hpp:306-308 — ids >= id_max map to
        (id % (id_max - 1)) + 1.
        """
        m = self.id_max
        return (ident % (m - 1)) + 1 if ident >= m else ident

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mode"] = self.mode.value
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ColBwtConfig":
        d = json.loads(text)
        d["mode"] = SplitMode(d["mode"])
        return cls(**d)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "ColBwtConfig":
        return cls.from_json(Path(path).read_text())


# The unique smallest sentinel/terminator byte.  The reference normalizes every
# byte <= 1 to TERMINATOR == 1 when reading BWT heads
# (include/common/common.hpp:72, include/ds/LF_table.hpp:111).
TERMINATOR = 1
