"""The control of `correct`: the reference put in the program's place with
one guarantee of the configuration broken, judged as a run's records are.

The configurations state no numeric precision; their guarantee is every
read's PML and CID as the col-BWT with the stated col-split defines them.
The control builds the col-split at twice the split rate (every 20th step
of a multi-MUM's walk marked, not every 10th), the shortcut that would make
the build's col-split cheaper, and must come out not correct:

    python3 bench_port/control.py --workload chr21_hap8.short \
        --seeds 11 12 13

For each seed it writes the cell's collection and one job's reads from the
run's own generators, works out the reference's records and the control's,
and prints the judge's numbers for the control's files, one JSON line a
seed.  It runs on the card when there is one, and needs no program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(spec, workload: str, seed: int, device: str) -> dict:
    """The judge's numbers for the control's records of one seed."""
    from bench_port import generate as G
    from bench_port import judge as J
    from bench_port import reference as R

    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    docs = G.collection(cfg, seed)
    reads = G.reads(docs, traffic, G.rng_for(seed, 1))
    b = cfg["build"]
    offs, _ = J.record_layout(reads.names, reads.lens)
    pml, cid, counts = R.records(docs, b, reads.seqs, reads.lens, device)
    cp, cc, ccounts = R.records(docs, b, reads.seqs, reads.lens, device,
                                split_rate=2 * b["split_rate"])
    return {
        "seed": seed,
        "pml_records_wrong": J.wrong_records(
            J.expected_file(reads.names, cp, reads.lens),
            J.expected_file(reads.names, pml, reads.lens), offs),
        "cid_records_wrong": J.wrong_records(
            J.expected_file(reads.names, cc, reads.lens),
            J.expected_file(reads.names, cid, reads.lens), offs),
        "marks_count_diff": abs(ccounts["marks"] - counts["marks"]),
        "records": int(reads.lens.size)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    from bench_port import harness as H

    spec = H.Spec(ROOT / "BENCHMARK.json")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_numbers(spec, args.workload, seed, device)
        out["seconds"] = time.perf_counter() - t0
        out["device"] = device
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
