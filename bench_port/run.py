"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output:

    python3 bench_port/run.py --workload chr21_hap8.short --seed 7 \
        --seconds 30 --trace 0

Exits with a code other than 0, printing no result, when there is no CUDA
device (or fewer than the cell asks for), when the cell is unknown, and
when a module of JAX or of the JAX package is loaded once the window has
closed.  The numbers that decide `correct` end standard error, each beside
its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # the program's native library builds with its Makefile's compiler: a
    # CXX in the environment (the H100 machines set one whose g++ cannot
    # link OpenMP) would fail `make -C native`
    os.environ.pop("CXX", None)
    # every compiler and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "bench_port"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path.insert(0, str(ROOT))

    from bench_port import harness as H

    spec = H.Spec(ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result, checks = H.run_cell(spec, args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_START, log)
    bad = H.forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package loaded: {bad}")
        return 3
    card = H.power_limit()
    result["device"]["power_limit"] = card
    log(f"card: {card}; {json.dumps(result['metrics'])}")
    for name, (value, limit) in checks.items():
        log(f"check {name} {value} limit {limit}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
