"""`correct` is a comparison that fails: the control (the reference at
twice the split rate, in the program's place) and faults planted in the
program's timed path come out not correct, at a size a test run holds."""

import numpy as np
import pytest

from bench_port import control as C
from bench_port import harness as H


@pytest.mark.parametrize("cell", ["chr21_hap8.short", "sarscov2_10k.short"])
def test_control_is_not_correct(tiny, cell):
    got = C.control_numbers(tiny, cell, 2**31 + 21, "cpu")
    assert got["pml_records_wrong"] == 0
    assert got["cid_records_wrong"] > 0


def _alter(monkeypatch, how):
    """Plant a fault where the program produces a batch's answers."""
    from colbwt_tpu_torch.pipeline import engines as E

    real = E.QueryEngines.materialize

    def faulty(result):
        p, c, lens = real(result)
        p, c = p.copy(), c.copy()
        if how == "pml":
            p[0, -1] += 1   # one base's PML of the batch's first read
        elif how == "cid":
            c[:, -1] ^= 1   # each read's last CID
        elif how == "half":
            return p[:p.shape[0] // 2], c[:p.shape[0] // 2], lens
        return p, c, lens

    monkeypatch.setattr(E.QueryEngines, "materialize", staticmethod(faulty))


@pytest.mark.parametrize("how,check", [("pml", "pml_records_wrong"),
                                       ("cid", "cid_records_wrong"),
                                       ("half", "jobs_failed")])
def test_faults_are_not_correct(tiny, monkeypatch, how, check):
    _alter(monkeypatch, how)
    res, checks = H.run_cell(tiny, "chr21_hap8.short", 77, 0.2, False,
                             "cpu", log=lambda m: None)
    assert res["correct"] is False
    assert checks[check][0] > checks[check][1]


def test_judge_counts_records():
    from bench_port import judge as J

    names = ["a", "bb", "c"]
    lens = np.array([3, 2, 4])
    vals = np.arange(12).reshape(3, 4)
    offs, _ = J.record_layout(names, lens)
    want = J.expected_file(names, vals, lens)
    assert want.size == offs[-1] == sum(2 + len(n) + 8 + 2 * m
                                        for n, m in zip(names, lens))
    assert want[:2].view("<u2")[0] == 1 and bytes(want[2:3]) == b"a"
    assert want[3:11].view("<u8")[0] == 3
    assert list(want[11:17].view("<u2")) == [0, 1, 2]
    got = want.copy()
    got[offs[1] + 5] ^= 1
    got[offs[2] + 11] ^= 1
    assert J.wrong_records(got, want, offs) == 2
    assert J.wrong_records(got[:-1], want, offs) == 3
    assert J.wrong_records(None, want, offs) == 3
