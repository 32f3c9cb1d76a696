"""The port's profiling hooks (colbwt_tpu_torch/utils/profiling.py)
against the JAX package's (colbwt_tpu/utils/profiling.py): `trace` writes
a Chrome trace holding the names `annotate` gave, and StepTimer reports
as JAX's does."""

import json

import pytest
import torch

from colbwt_tpu.utils import profiling as JP
from colbwt_tpu_torch.utils import profiling as TP


def test_trace_holds_annotations(tmp_path):
    with TP.trace(str(tmp_path / "prof"), device="cpu") as prof:
        assert prof is not None
        with TP.annotate("colbwt_region"):
            torch.arange(1000).sum()
    data = json.loads((tmp_path / "prof" / TP.TRACE_FILE).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    assert any(e.get("name") == "colbwt_region" for e in events)


def test_trace_none_is_a_no_op(tmp_path):
    with TP.trace(None) as prof, TP.annotate("outside a trace"):
        assert prof is None
    assert not any(tmp_path.iterdir())


def test_trace_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        with TP.trace(str(tmp_path / "prof")):
            pass


@pytest.mark.parametrize("stages", [
    {}, {"scan": 1.25}, {"read": 0.5, "scan": 2.0, "write": 0.0005},
    {"a": 0.0, "b": 0.0}])
def test_step_timer_report_equals_jax(stages):
    got, want = TP.StepTimer(), JP.StepTimer()
    got.stages, want.stages = dict(stages), dict(stages)
    assert got.report() == want.report()


def test_step_timer_accumulates():
    t = TP.StepTimer()
    for _ in range(3):
        with t.stage("x"):
            pass
    with t.stage("y"):
        pass
    assert set(t.stages) == {"x", "y"} and t.stages["x"] >= 0
    assert t.report().count("\n") == 1
