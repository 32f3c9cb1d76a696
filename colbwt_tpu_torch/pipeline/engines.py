"""Query-engine selection and batch dispatch — port of
colbwt_tpu/pipeline/engines.py.

The selection logic is the JAX package's ladder (engines.py:28-91), kept
as it is, with all five rungs:

- positional automaton (k chars per gather; ops/query_pos.py, kernels
  K1-K3), chosen for large workloads when its tables fit the budget;
- mega-wide (n >= 2**31: two-limb positions, one row per char;
  ops/query_mega_wide.py, kernels K6a-K6c), for every wide index;
- mega (one row per char; ops/query_mega.py, kernel K5), for a run-split
  narrow index the positional tables cannot serve;
- fused (K+1 gathers a char, for a run-split index with ff_bound >= 1;
  ops/query_fused.py, kernel K7, tables uploaded by K14);
- compact engine (table-free; ops/query_xla.py, kernel K4).

On CUDA a batch goes up from pinned host memory without blocking (through
utils/xfer.upload_chunked, K14, when it is larger than one chunk), its
outputs come down into pinned host tensors without blocking, and an event
recorded after them is what `materialize` waits on: the device is never
synchronized, so the streaming query's next batch runs while the host
drains this one.

Each engine records into a span recorder (utils/profiling.StepTimer; the
streaming query passes its job's): `engine.encode` and `engine.launch`
spans a dispatch, `engine.wait` and `engine.unpack` a materialize, and
the counters `scanned_bases`, `padded_cells`, `fallback_reads`, `bytes_up`
and `bytes_down`.

With a `table_dir` (the one-shot and streaming queries and the build's
prewarm pass `<index_prefix>.torch_tables`), the pos, mega and mega-wide
tables go through the persisted table cache (pipeline/tables.py) as the
JAX package's do (engines.py:93-151): loaded when the measured load time
beats the recorded build, saved when the measured save and load together
beat the build just measured, every choice recorded in `cache_events`.
The fused tables are not cached, as in JAX.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import index_tensors, to_device
from colbwt_tpu_torch.ops import (query_fused, query_mega, query_mega_wide,
                                  query_pos, query_xla)
from colbwt_tpu_torch.pipeline import tables as TB
from colbwt_tpu_torch.utils.config import ColBwtConfig
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.hbm import resolve_pos_budget
from colbwt_tpu_torch.utils.profiling import StepTimer
from colbwt_tpu_torch.utils.xfer import CHUNK_BYTES, upload_chunked


class QueryEngines:
    """Owns the device tables for one index and dispatches read batches."""

    def __init__(self, index: ColPmlIndex, cfg: ColBwtConfig,
                 total_chars: int | None = None,
                 table_dir: str | None = None, device=None,
                 timer: StepTimer | None = None):
        self.index = index
        self.timer = timer if timer is not None else StepTimer()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.table_dir = table_dir if cfg.table_cache != "off" else None
        self.cache_events: list[dict] = []  # load/build provenance a table
        # The pos tables cost O(A^k n) device work to build, so under "auto"
        # they only pay off for real workloads; total_chars=None means "the
        # workload is large/unbounded"
        large = total_chars is None or total_chars >= 1_000_000
        budget = resolve_pos_budget(cfg.pos_hbm_budget, self.device)
        pos_k = (query_pos.choose_k(index, budget)
                 if (not index.wide and cfg.engine in ("auto", "pos")) else 0)
        pos_alpha = None
        # the restricted-alphabet upgrade runs even when the general table
        # does not fit (pos_k == 0)
        if (not index.wide and cfg.engine in ("auto", "pos")
                and set(index.alphabet.tolist()) - {1} <= set(b"ACGT")):
            kq = query_pos.choose_k(index, budget, alphabet=b"ACGT")
            if kq >= max(pos_k, 1):
                pos_k, pos_alpha = kq, b"ACGT"
        self.pos_k = pos_k
        # packed (pml << 8 | cid) planes need 8-bit cids; an id_bits > 8
        # index gets two-plane outputs from the mega engines
        self._cid8 = int(index.col_id.max(initial=0)) <= 0xFF
        self.use_pos = pos_k >= 1 and (cfg.engine == "pos" or large)
        self.use_wide = index.wide
        if self.use_wide and index.ff_bound < 2:
            raise ValueError("wide index lacks run splitting (ff_bound < 2); "
                             "rebuild with ColPmlIndex.build")
        self.use_mega = (not self.use_pos and not self.use_wide
                         and index.ff_bound >= 2
                         and cfg.engine in ("auto", "mega"))
        self.use_fused = (not self.use_pos and not self.use_wide
                          and not self.use_mega and index.ff_bound >= 1
                          and cfg.engine in ("auto", "fused"))
        # the synchronised build or load of the tables, and the save's
        self.table_build_seconds = 0.0
        self.table_save_seconds = 0.0
        self.pt = None
        self.mt = None
        self.ft = None
        if self.use_pos:
            # the entry is keyed by all that shaped the tables
            layout = {"k": pos_k, "alphabet": (None if pos_alpha is None
                                               else pos_alpha.hex()),
                      "t1": query_pos.keeps_general_t1(index, pos_k,
                                                       pos_alpha, budget)}
            self.pt = self._tables("pos", lambda: query_pos.build_pos_tables(
                index, pos_k, hbm_budget_bytes=budget, alphabet=pos_alpha,
                device=self.device), layout)
        elif self.use_wide:
            compact = query_mega_wide.choose_compact(index, budget)
            self.mt = self._tables(
                "megawide", lambda: query_mega_wide.build_mega_table_wide(
                    index, compact=compact, device=self.device),
                {"compact": compact})
        elif self.use_mega:
            self.mt = self._tables("mega", lambda: query_mega.build_mega_table(
                index, device=self.device), {})
        elif self.use_fused:
            self.ft, self.table_build_seconds = self._timed(
                lambda: query_fused.build_fused_tables(index, self.device))
        self._xla_tb = None

    def _timed(self, fn):
        """(fn(), its seconds with the device synchronised after it)."""
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - t0

    def _tables(self, kind: str, build_fn, layout: dict) -> dict:
        """An engine's tables, built or loaded from the cache in
        `table_dir` (pipeline/tables.py), with one provenance event either
        way.  Under "auto" an entry is loaded when its projected load (its
        device bytes over `TB.read_rate`) beats the build seconds it
        recorded, and removed when it does not (a save is held to a
        stricter rule, so it would not be saved again); a build is saved
        when the projected save plus the projected load
        (`TB.project_save`) beat the build just measured, that is when one
        later load repays the save.  "force" always loads and saves, and
        projects nothing.  An entry of another index or layout is a miss.
        A directory that cannot be read or written costs the cache, never
        the query: the tables are built and the event says why none was
        saved."""
        if self.table_dir is None:
            tbl, self.table_build_seconds = self._timed(build_fn)
            return tbl
        force = self.cfg.table_cache == "force"
        meta = TB.peek(self.table_dir, kind, self.index, layout)
        if meta is not None:
            build_s = meta.get("build_seconds")
            proj = None
            t0 = time.perf_counter()
            if not (force or meta["largest"] is None or build_s is None):
                try:
                    proj = meta["dev_bytes"] / TB.read_rate(meta["largest"],
                                                            self.device)
                except (OSError, ValueError):
                    meta = None  # removed or truncated meanwhile: a miss
            probe_s = time.perf_counter() - t0
            if meta is not None and (proj is None or proj < build_s):
                got, secs = self._timed(lambda: TB.load_tables(
                    self.table_dir, kind, self.index, self.device, layout))
                if got is not None:
                    self.table_build_seconds = secs
                    self.cache_events.append({
                        "kind": kind, "event": "load", "seconds": secs,
                        "projected_seconds": proj, "probe_seconds": probe_s,
                        "replaced_build_seconds": build_s})
                    return got[0]
                meta = None  # a half-written entry: build and save anew
            elif meta is not None:
                self.cache_events.append({
                    "kind": kind, "event": "skip-load",
                    "projected_seconds": proj, "probe_seconds": probe_s,
                    "build_seconds": build_s,
                    "removed": TB.remove_tables(self.table_dir, kind)})
        tbl, build_s = self._timed(build_fn)
        self.table_build_seconds = build_s
        if meta is not None:  # an entry declined: not saved again
            return tbl
        ev = {"kind": kind, "event": "build+skip-save", "seconds": build_s}
        if force:
            ev.update(projected_save_seconds=None, projected_seconds=None,
                      probe_seconds=0.0)
        else:
            got = TB.project_save(self.table_dir, tbl, build_s, self.device)
            ev.update(projected_save_seconds=got["save_seconds"],
                      projected_seconds=got["load_seconds"],
                      probe_seconds=got["probe_seconds"])
            if "error" in got:
                ev["reason"] = got["error"]
        if force or (ev["projected_seconds"] is not None and "reason" not in ev
                     and ev["projected_save_seconds"]
                     + ev["projected_seconds"] < build_s):
            t0 = time.perf_counter()
            try:
                TB.save_tables(self.table_dir, kind, self.index, tbl,
                               build_seconds=build_s, layout=layout)
                ev["event"] = "build+save"
            except OSError as e:
                ev["reason"] = f"{type(e).__name__}: {e}"
            self.table_save_seconds = time.perf_counter() - t0
            ev["save_seconds"] = self.table_save_seconds
        self.cache_events.append(ev)
        return tbl

    @property
    def name(self) -> str:
        if self.use_pos:
            return f"pos(k={self.pos_k})"
        if self.use_wide:
            return "mega-wide"
        if self.use_mega:
            return "mega"
        if self.use_fused:
            return "fused"
        return "xla"

    def _compact_tables(self) -> dict:
        if self._xla_tb is None:
            self._xla_tb = index_tensors(self.index, self.device)
        return self._xla_tb

    def _up(self, a: np.ndarray, dtype=np.int32) -> torch.Tensor:
        """A host array on the device without blocking: from pinned memory,
        or through upload_chunked (K14) when larger than one chunk."""
        a = np.ascontiguousarray(a, dtype=dtype)
        self.timer.count("bytes_up", a.nbytes)
        if self.device.type == "cpu":
            return to_device(a, self.device, dtype)
        if a.nbytes > CHUNK_BYTES:
            return upload_chunked(a, self.device)
        return torch.from_numpy(a).pin_memory().to(self.device,
                                                   non_blocking=True)

    def _down(self, t: torch.Tensor | None) -> torch.Tensor | None:
        """A device output copied into pinned host memory without blocking
        (a CPU tensor stays as it is)."""
        if t is None:
            return t
        self.timer.count("bytes_down", t.numel() * t.element_size())
        if self.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    # ------------------------------------------------------------------
    def dispatch(self, batch: list[bytes], padded: int):
        """Launch one device batch without waiting for it; returns (pml,
        cid, lens, fallback, event, timer) for `materialize`: the outputs on
        their way into pinned host tensors, the CUDA event recorded after
        those copies (None on the CPU) and the recorder its spans go to.
        On the pos and mega engines the pml side may be one packed
        pml << 8 | cid plane, and the cid side is then None."""
        p, c, lens, fallback = self._scan(batch, padded)
        with self.timer.stage("engine.launch"):
            p, c = self._down(p), self._down(c)
            if fallback is not None:
                idxs, p2, c2 = fallback
                fallback = (idxs, self._down(p2), self._down(c2))
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        return p, c, lens, fallback, event, self.timer

    def _launched(self, lens: np.ndarray, padded: int) -> None:
        """Count one scan launched over reads of `lens` padded to
        `padded` columns."""
        self.timer.count("scanned_bases", int(lens.sum()))
        self.timer.count("padded_cells", lens.size * padded)

    def _scan(self, batch: list[bytes], padded: int):
        """Encode, upload and launch one batch: (device pml, device cid,
        lens, fallback)."""
        index, pt, tm = self.index, self.pt, self.timer
        if self.use_pos:
            # M must divide both k (key folding) and the digit-packing
            # group (4 digits/byte at A <= 4, 2 at A <= 16)
            per = 4 if pt["A"] <= 4 else (2 if pt["A"] <= 16 else 1)
            grp = math.lcm(self.pos_k, per)  # e.g. k=3, per=4 -> 12
            padded = -(-padded // grp) * grp
            if padded > 255 and max(len(r) for r in batch) <= 252:
                padded = 252  # largest <= 255 multiple of every k <= 4:
                # keeps the u16 packed plane for reads whose power-of-2
                # bucket would round to 256
            with tm.stage("engine.encode"):
                dig, lens, bad = query_pos._encode_digits(index, pt, batch,
                                                          padded)
                dig, pack = query_pos.pack_digits(dig, pt["A"])
            with tm.stage("engine.launch"):
                p, c = query_pos.query_batch_pos(
                    pt["table"], pt["n"], self._up(dig, np.uint8),
                    self._up(lens), k=self.pos_k, A=pt["A"], packed_out=True,
                    pack=pack)
            self._launched(lens, padded)
            if bad.any():  # reads with non-key bytes: general k=1 fallback
                idxs = np.flatnonzero(bad)
                tm.count("fallback_reads", idxs.size)
                with tm.stage("engine.encode"):
                    e2, l2 = index.encode_patterns([batch[i] for i in idxs],
                                                   padded)
                with tm.stage("engine.launch"):
                    if pt["t1"] is not None:
                        p2, c2 = query_pos.query_batch_pos(
                            pt["t1"], pt["n"], self._up(e2, np.uint8),
                            self._up(l2), k=1, A=pt["A_full"])
                    else:  # general T1 does not fit: compact engine
                        p2, c2 = query_xla.query_batch_device(
                            self._compact_tables(), self._up(e2),
                            self._up(l2), ff_bound=index.ff_bound)
                self._launched(l2, padded)
                return p, c, lens, (idxs, p2, c2)
            return p, c, lens, None
        if self.use_wide or self.use_mega:
            if padded > 255 and max(len(r) for r in batch) <= 255:
                padded = 255  # keep the u16 packed plane for short reads
                # whose power-of-2 bucket would round to 256
            with tm.stage("engine.encode"):
                enc, lens = index.encode_patterns(batch, padded)
            scan = (query_mega_wide.query_batch_mega_wide if self.use_wide
                    else query_mega.query_batch_mega)
            # uint8 dense ids up; one packed plane down (u16 at padded <=
            # 255, else int32, lossless below the 2**23 pml guard with 8-bit
            # cids), two planes otherwise
            with tm.stage("engine.launch"):
                p, c = scan(self.mt, self._up(enc, np.uint8), self._up(lens),
                            ff_bound=index.ff_bound,
                            packed_out=self._cid8 and padded < (1 << 23))
            self._launched(lens, padded)
            return p, c, lens, None
        with tm.stage("engine.encode"):
            enc, lens = index.encode_patterns(batch, padded)
        with tm.stage("engine.launch"):
            if self.use_fused:  # uint8 ids up: a quarter of the int32 bytes
                p, c = query_fused.query_batch_fused(
                    self.ft, self._up(enc, np.uint8), self._up(lens),
                    ff_bound=index.ff_bound)
            else:
                p, c = query_xla.query_batch_device(
                    self._compact_tables(), self._up(enc), self._up(lens),
                    ff_bound=index.ff_bound)
        self._launched(lens, padded)
        return p, c, lens, None

    @staticmethod
    def materialize(result) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for a dispatch() result's event (not for the device);
        returns (pml (B, W), cid (B, W), lens (B,)) with any fallback reads
        spliced back in.  A packed plane (cid side None) is split on the
        host."""
        p_host, c_host, lens, fallback, event, tm = result
        with tm.stage("engine.wait"):
            if event is not None:
                event.synchronize()
        with tm.stage("engine.unpack"):
            if c_host is None:
                p, c = query_pos.unpack_pml_cid(p_host.numpy())
            else:
                p = p_host.numpy()
                c = c_host.numpy()
            if fallback is not None:
                idxs, p2, c2 = fallback
                p[idxs] = p2.numpy()
                c[idxs] = c2.numpy()
        return p, c, np.asarray(lens)

    # ------------------------------------------------------------------
    def query_long_reads(self, reads: list[bytes]
                         ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Chunked carried-state scans for reads beyond cfg.long_read_len
        (the -l mode, src/pml_query.cpp:126-128)."""
        chunk = self.cfg.long_read_chunk
        if self.use_pos:
            return query_pos.query_long_reads(self.index, reads, chunk=chunk,
                                              pt=self.pt)
        if self.use_wide:
            return query_mega_wide.query_long_reads(self.index, reads,
                                                    chunk=chunk, mt=self.mt)
        if self.use_mega:
            return query_mega.query_long_reads(self.index, reads, chunk=chunk,
                                               mt=self.mt)
        # the fused and compact engines handle any length in one batch (no
        # table growth with M) — reuse dispatch at the padded length
        padded = 1 << (max(max(len(r) for r in reads), 1) - 1).bit_length()
        p, c, lens = self.materialize(self.dispatch(reads, padded))
        W = p.shape[1]
        return ([p[i, W - int(lens[i]):] for i in range(len(reads))],
                [c[i, W - int(lens[i]):] for i in range(len(reads))])

    def supports_long_streaming(self) -> bool:
        return self.use_pos or self.use_mega or self.use_wide
