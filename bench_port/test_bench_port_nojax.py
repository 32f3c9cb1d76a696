"""No module the harness or the reference loads is JAX's or the JAX
package's, and the reference loads nothing of the program; compared by
whole top-level names (the port's name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import sys
sys.path.insert(0, {root!r})
{imports}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "colbwt_tpu"}}))
print("colbwt_tpu_torch" in tops)
"""


def _probe(imports: str) -> tuple[str, str]:
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, check=True)
    bad, torch_port = out.stdout.split("\n")[:2]
    return bad, torch_port


def test_reference_loads_neither_jax_nor_the_program():
    bad, port = _probe("from bench_port import reference, judge, generate, "
                       "roofline, control")
    assert bad == "[]" and port == "False"


def test_harness_and_a_run_load_no_jax(tmp_path):
    from bench_port.conftest import tiny_spec

    path = tiny_spec(tmp_path)
    bad, port = _probe(
        "from bench_port import harness as H\n"
        "import bench_port.run\n"
        f"spec = H.Spec({str(path)!r}, {str(tmp_path / 'bench')!r})\n"
        "H.run_cell(spec, 'chr21_hap8.short', 3, 0.1, True, 'cpu',\n"
        "           log=lambda m: None)\n"
        "assert not H.forbidden_modules()")
    assert bad == "[]" and port == "True"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from bench_port import harness as H

    monkeypatch.setitem(sys.modules, "colbwt_tpu_torch_x", sys)
    assert "colbwt_tpu_torch_x" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in H.forbidden_modules()
