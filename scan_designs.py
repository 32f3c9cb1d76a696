#!/usr/bin/env python3
"""Design sweep of the scans K5, K6a and K7 on one CUDA card.

    python3 scan_designs.py [--parent DIR]

Builds bench.py's index and reads as chip_smoke.py's phase 3 does, the
run-split indexes with ff_bound 2 and 1 and the indexes with run lengths
x256 (mega) and x1024 (mega-wide), then times on the same inputs, in
turns, the shipped kernels of colbwt_tpu_torch/csrc (query_fused.cu,
query_mega.cu) beside variants of them.  Each variant is the shipped
source with one change, compiled into a library of its own:

- row-major (K7): the outputs stored (B, M) row-major, not transposed;
- column-major (K5, K6a): the outputs stored (M, B) column-major and
  transposed on the device, as the mega chunk scan stores them;
- threads-32, threads-64 (K5, K6a), threads-128 (K7): that block size in
  place of the shipped one (64 threads for K7, 128 for K5 and K6a);
- jump-on-mismatch (K7): the jump row loaded only when the step's
  character mismatches the run's, after the run row.

With --parent DIR (a checkout of the parent commit) its query_fused.cu and
query_mega.cu are timed too, called as its wrappers called them (int32 ids
for K7, row-major planes).  Every variant's outputs must equal the shipped
kernel's.  A time is the mean of `reps` calls between CUDA events after
one warm-up, a column-major design's device transposes included; the
shipped kernel is timed first and again last at each shape.  Prints the
card's name and power limit first and one JSON line of every time last
(also written to build/scan_designs/times.json); exits nonzero without
CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "scan_designs"
SOURCES = ("query_fused.cu", "query_mega.cu")

_FUSED_STORE = ("    pml_out[col * B + b] = new_len;\n"
                "    cid_out[col * B + b] = cid;\n")
_FUSED_JUMP = ("      const int4 ja = __ldg(&jump_rows[2 * jf]);\n"
               "      const int4 jb = __ldg(&jump_rows[2 * jf + 1]);\n"
               "\n"
               "      const bool match = ra.x == c;\n")
_FUSED_THREADS = "constexpr int kThreads = 64;\n"
_MEGA_THREADS = "constexpr int kThreads = 128;\n"
# variant -> [(source, shipped text, the variant's text)]
VARIANTS = {
    "row-major": [
        ("query_fused.cu", _FUSED_STORE,
         _FUSED_STORE.replace("col * B + b", "b * M + col"))],
    "column-major": [
        ("query_mega.cu", "constexpr bool kBatchColMajor = false;\n",
         "constexpr bool kBatchColMajor = true;\n")],
    "jump-on-mismatch": [
        ("query_fused.cu", _FUSED_JUMP,
         "      const bool match = ra.x == c;\n"
         "      int4 ja = make_int4(0, 0, 0, 0), jb = ja;\n"
         "      if (!match) {\n"
         "        ja = __ldg(&jump_rows[2 * jf]);\n"
         "        jb = __ldg(&jump_rows[2 * jf + 1]);\n"
         "      }\n")],
    "threads-32": [
        ("query_fused.cu", _FUSED_THREADS, _FUSED_THREADS.replace("64", "32")),
        ("query_mega.cu", _MEGA_THREADS, _MEGA_THREADS.replace("128", "32"))],
    "threads-64": [
        ("query_mega.cu", _MEGA_THREADS, _MEGA_THREADS.replace("128", "64"))],
    "threads-128": [
        ("query_fused.cu", _FUSED_THREADS,
         _FUSED_THREADS.replace("64", "128"))],
}
FUSED_VARIANTS = ("row-major", "jump-on-mismatch", "threads-32",
                  "threads-128")
MEGA_VARIANTS = ("column-major", "threads-32", "threads-64")


def log(msg: str) -> None:
    print(msg, flush=True)


def build_libraries(parent: Path | None) -> dict[str, ctypes.CDLL]:
    """The shipped sources, each variant and the parent's, each compiled
    into a library of its own (one nvcc each, all side by side)."""
    from colbwt_tpu_torch.ops import _kernels as K

    csrc = REPO / "colbwt_tpu_torch" / "csrc"
    trees = {"shipped": (csrc, [])}
    trees.update({name: (csrc, subs) for name, subs in VARIANTS.items()})
    if parent is not None:
        trees["parent"] = (parent / "colbwt_tpu_torch" / "csrc", [])
    cmds, libs = [], {}
    for name, (src, subs) in trees.items():
        out = WORK / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for h in src.glob("*.cuh"):
            shutil.copy(h, out / h.name)
        for f in SOURCES:
            text = (src / f).read_text()
            for file, old, new in subs:
                if file == f:
                    if text.count(old) != 1:
                        raise RuntimeError(f"{name}: {f} no longer holds the "
                                           f"text the variant changes")
                    text = text.replace(old, new)
            (out / f).write_text(text)
        cmds.append([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
                     str(out / "lib.so"), *(str(out / f) for f in SOURCES)])
    K._run_all(cmds)
    for name in trees:
        lib = ctypes.CDLL(str(WORK / name / "lib.so"))
        for fn in ("colbwt_query_batch_fused", "colbwt_query_chunk_mega",
                   "colbwt_query_chunk_mega_wide"):
            getattr(lib, fn).argtypes = K._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_designs: needs a CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    sys.path.insert(0, str(REPO))
    from bench import make_docs
    from chip_smoke import (cuda_ms, finish_native_build, load_table,
                            query_reads, scale_table, start_native_build)
    from colbwt_tpu_torch.io.fasta import FastaRecord, write_fasta
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.models.tensors import to_device
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_fused as TF
    from colbwt_tpu_torch.ops import query_mega as TM
    from colbwt_tpu_torch.ops import query_mega_wide as TW
    from colbwt_tpu_torch.pipeline import build_pipeline
    from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    native = start_native_build()
    libs = build_libraries(args.parent)
    finish_native_build(native)
    log(f"[designs] {len(libs)} libraries built in "
        f"{time.perf_counter() - t0:.1f}s: {', '.join(libs)}")

    t0 = time.perf_counter()
    docs = make_docs()
    fastas = []
    for i, d in enumerate(docs):
        fastas.append(str(WORK / f"hap{i}.fa"))
        write_fasta(fastas[-1], [FastaRecord(f"hap{i}", d)])
    prefix = str(WORK / "bench")
    build_pipeline(fastas, prefix, ColBwtConfig(
        mode=SplitMode.TUNNELS, split_rate=10, min_mum=20, keep_temp=True),
        device=dev)
    tbl = load_table(prefix)
    reads, n_reads, long_reads = query_reads(
        docs, np.random.default_rng(0x5A0E))
    split = ColPmlIndex.build(tbl, ff_bound=2)
    ff1 = ColPmlIndex.build(tbl, ff_bound=1)
    mega = ColPmlIndex.build(scale_table(tbl, 256), ff_bound=2)
    wide = ColPmlIndex.build(scale_table(tbl, 1024), ff_bound=2)
    log(f"[designs] indexes and reads in {time.perf_counter() - t0:.1f}s")

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sample = reads[:8192 - 256] + n_reads[:256]
    streamed = reads[:32768 - 256] + n_reads[:256]
    times: dict = {}

    def compare(shape: str, designs: dict, reps: int) -> None:
        """Hold every design's outputs to the shipped kernel's, then time
        them in turns (the shipped kernel first and last)."""
        want = designs["shipped"]()
        for name, fn in designs.items():
            for g, w in zip(fn(), want):
                if g is None:
                    continue
                if g.dtype == torch.uint16:
                    g, w = g.view(torch.int16), w.view(torch.int16)
                if not torch.equal(g, w):
                    raise RuntimeError(f"{shape}: {name} differs from the "
                                       f"shipped kernel")
        order = list(designs) + ["shipped"]
        ms = {}
        for name in order:
            key = "shipped (again)" if name in ms else name
            ms[key] = cuda_ms(torch, designs[name], reps)
        times[shape] = ms
        log(f"[designs] {shape}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()))

    # K7
    def fused(lib, ft, pats, lens, ff, row_major=False):
        B, M = pats.shape
        shape = (B, M) if row_major else (M, B)
        pml = torch.empty(shape, dtype=torch.int32, device=dev)
        cid = torch.empty(shape, dtype=torch.int32, device=dev)
        K.check("query_batch_fused", lib.colbwt_query_batch_fused(
            ft["run_rows"].data_ptr(), ft["jump_rows"].data_ptr(),
            ft["length"].data_ptr(), ft["r"], ft["jump_rows"].shape[0],
            ft["n"], pats.data_ptr(), lens.data_ptr(), B, M, ff,
            pml.data_ptr(), cid.data_ptr(), stream()))
        if row_major:
            return pml, cid
        return pml.t().contiguous(), cid.t().contiguous()

    for idx, cells in ((split, (("E long reads", long_reads, 8192, 3),
                                ("E dispatch", sample, 256, 20),
                                ("S-E dispatch", streamed, 256, 20))),
                       (ff1, (("F long reads", long_reads, 8192, 3),
                              ("F dispatch", sample, 256, 20)))):
        ft = TF.build_fused_tables(idx, dev)
        ff = idx.ff_bound
        for label, batch, M, reps in cells:
            enc, ln = idx.encode_patterns(batch, M)
            pats = to_device(enc, dev, np.uint8)
            pats32 = to_device(enc, dev)
            lens = to_device(ln, dev)
            designs = {
                name: (lambda lib=libs[name], rm=name == "row-major":
                       fused(lib, ft, pats, lens, ff, row_major=rm))
                for name in ("shipped",) + FUSED_VARIANTS}
            if "parent" in libs:
                designs["parent"] = lambda: fused(libs["parent"], ft, pats32,
                                                  lens, ff, row_major=True)
            compare(f"K7 {label} {len(batch)}x{M} ff_bound={ff}", designs,
                    reps)
        del ft

    # K5, K6a
    def rows(plane):
        """An (M, B) plane as (B, M) on the device (a uint16 plane through
        its int16 view)."""
        if plane is None:
            return None
        if plane.dtype == torch.uint16:
            return plane.view(torch.int16).t().contiguous().view(torch.uint16)
        return plane.t().contiguous()

    def scan(lib, mt, ff, pats, lens, state, step_offset, masked, mode,
             row_major):
        B, M = pats.shape
        shape = (B, M) if row_major else (M, B)
        out0 = torch.empty(shape, dtype=torch.uint16 if mode == 2
                           else torch.int32, device=dev)
        out1 = (torch.empty(shape, dtype=torch.int32, device=dev)
                if mode == 0 else None)
        final = [torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in state]
        common = (pats.data_ptr(), lens.data_ptr(),
                  *(t.data_ptr() for t in state), step_offset, B, M, ff,
                  int(masked), mode, out0.data_ptr(),
                  None if out1 is None else out1.data_ptr(),
                  *(t.data_ptr() for t in final), stream())
        if "percha" in mt:
            K.check("query_chunk_mega_wide", lib.colbwt_query_chunk_mega_wide(
                1, mt["percha"].data_ptr(), mt["percha"].shape[0],
                mt["shared"].data_ptr(), mt["length"].data_ptr(), mt["r"],
                mt["n_hi"] * TW.LIMB + mt["n_lo"], *common))
        elif "n_hi" in mt:
            K.check("query_chunk_mega_wide", lib.colbwt_query_chunk_mega_wide(
                0, mt["mega"].data_ptr(), mt["mega"].shape[0], None,
                mt["length"].data_ptr(), mt["r"],
                mt["n_hi"] * TW.LIMB + mt["n_lo"], *common))
        else:
            K.check("query_chunk_mega", lib.colbwt_query_chunk_mega(
                mt["mega"].data_ptr(), mt["mega"].shape[0],
                mt["length"].data_ptr(), mt["r"], mt["n"], *common))
        if row_major:
            return out0, out1, *final
        return rows(out0), rows(out1), *final

    for label, idx, mt, init in (
            ("C", mega, TM.build_mega_table(mega, device=dev),
             TM.initial_state),
            ("D full", wide,
             TW.build_mega_table_wide(wide, compact=False, device=dev),
             TW.initial_state_wide),
            ("D compact", wide,
             TW.build_mega_table_wide(wide, compact=True, device=dev),
             TW.initial_state_wide)):
        enc, ln = idx.encode_patterns(sample, 255)
        disp = (to_device(enc, dev, np.uint8), to_device(ln, dev),
                init(mt, len(sample)), 0, False)
        enc, ln = idx.encode_patterns(long_reads, 3 * 2048)
        pat = to_device(enc, dev, np.uint8)
        lt = to_device(ln, dev)
        kern = (TM.query_chunk_mega if label == "C"
                else TW.query_chunk_mega_wide)
        ff = idx.ff_bound
        _, st = kern(mt, pat[:, 4096:].contiguous(), lt,
                     init(mt, len(long_reads)), 0, ff_bound=ff,
                     packed_out=True)
        long = (pat[:, 2048:4096].contiguous(), lt, st, 2048, True)
        cells = [("long-read chunk 16x2048 packed int32", long, 1, 3),
                 ("dispatch 8192x255 u16", disp, 2, 20)]
        if label == "C":
            cells.append(("dispatch 8192x255 two planes", disp, 0, 20))
        for what, a, mode, reps in cells:
            designs = {
                name: (lambda lib=libs[name], rm=name != "column-major":
                       scan(lib, mt, ff, *a, mode, rm))
                for name in ("shipped",) + MEGA_VARIANTS}
            if "parent" in libs:
                designs["parent"] = lambda: scan(libs["parent"], mt, ff, *a,
                                                 mode, True)
            compare(f"{'K5' if label == 'C' else 'K6a'} {label} {what}",
                    designs, reps)
        del mt

    WORK.mkdir(parents=True, exist_ok=True)
    line = json.dumps({"card": card, "times": times})
    (WORK / "times.json").write_text(line + "\n")
    print(card)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
