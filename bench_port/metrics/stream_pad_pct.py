"""The share of the launched scans' cells that were padding, in %, the
mean over the window's jobs: 100 × (1 − scanned_bases / padded_cells)."""

from bench_port import spans as S


def read(run):
    return S.pad_pct(run)
