"""scan_designs.py, the design sweep of the scans K3, K4, K5, K6a and K7,
the col-split walks K10a and K10b, the LCP lift K11b, the sharded
composition K13d, the multi-MUM window K8/K9 and the thresholds'
segmented argmin K12: every variant it times still applies to the
shipped sources of its group, and without CUDA it exits
nonzero before it builds anything.  (The sweep itself runs on the card
only.)"""

import subprocess
import sys
from pathlib import Path

import pytest

import scan_designs as SD

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "colbwt_tpu_torch" / "csrc"


@pytest.mark.parametrize("variant", sorted(SD.VARIANTS))
def test_variant_changes_one_place_of_the_sources(variant):
    group = next(g for g, names in SD.GROUP_VARIANTS.items()
                 if variant in names)
    for source, old, new in SD.VARIANTS[variant]:
        assert source in SD.SOURCES and source in SD.GROUPS[group]
        assert (CSRC / source).read_text().count(old) == 1, source
        assert old != new


def test_every_variant_is_timed():
    assert (set(SD.FUSED_VARIANTS) | set(SD.MEGA_VARIANTS)
            | set(SD.LCP_VARIANTS) | set(SD.TK_VARIANTS)
            | set(SD.POS_VARIANTS) | set(SD.WALK_VARIANTS)
            | set(SD.STEP_VARIANTS) | set(SD.MUMS_VARIANTS)
            | set(SD.THR_VARIANTS) | set(SD.XLA_VARIANTS)) == set(SD.VARIANTS)
    assert set(SD.GROUP_VARIANTS) == set(SD.GROUPS) == set(SD.ENTRY_POINTS)
    timed = [v for names in SD.GROUP_VARIANTS.values() for v in names]
    assert sorted(timed) == sorted(SD.VARIANTS)


def test_exits_nonzero_without_cuda():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['scan_designs.py']; import scan_designs; "
         "sys.exit(scan_designs.main())"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "needs a CUDA device" in out.stderr
    assert not out.stdout
