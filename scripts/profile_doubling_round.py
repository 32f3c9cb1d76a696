#!/usr/bin/env python3
"""Device time of each kernel of K11a's rounds (`doubling_round`,
colbwt_tpu_torch/csrc/suffix.cu) on bench.py's suffix array (n =
4,000,004), on one CUDA card.

    python3 scripts/profile_doubling_round.py

Runs the rounds as `suffix_array` does (the previous round's order, one
workspace), then times each round: 20 calls between CUDA events, and under
torch.profiler the device time a call spends in each kernel, all its
launches together (the state's memset, the histogram, the radix scatter
passes, the re-rank), beside one stable torch.sort of the 32-bit ranks.
Prints the card's name and power limit first; exits nonzero without
CUDA.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from bench import make_docs
    from chip_smoke import cuda_ms
    from colbwt_tpu_torch.ops import construct as TC
    from colbwt_tpu_torch.ops import oracle as O

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    _, ranks, _ = O.concat_collection(make_docs())
    n = ranks.size
    ws = TC.DoublingWorkspace(n, dev)
    rank = torch.from_numpy(ranks.astype(np.int32)).to(dev)
    max_rank, k, sa, rounds = int(ranks.max()), 1, None, []
    while True:
        rounds.append((rank, k, max_rank, sa))
        sa, rank, top = TC.doubling_round(rank, k, max_rank, sa, ws)
        max_rank, k = int(top), 2 * k
        if max_rank == n - 1:
            break
    for rank_in, k_in, top_in, order_in in rounds:
        def call():
            TC.doubling_round(rank_in, k_in, top_in, order_in, ws)

        ms = cuda_ms(torch, call, 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "")
                per[name.split("(")[0]] = e.device_time_total / 10
        sort32 = cuda_ms(torch, lambda: torch.sort(rank_in, stable=True), 20)
        passes = TC.key_passes(top_in)
        print(f"k = {k_in}: {passes} passes, "
              f"{TC.round_launches(passes, order_in is not None)} launches, "
              f"{ms:.4f} ms a round ("
              + ", ".join(f"{name} {us:.1f} us" for name, us in
                          sorted(per.items()))
              + f"); stable torch.sort of the 32-bit ranks {sort32:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
