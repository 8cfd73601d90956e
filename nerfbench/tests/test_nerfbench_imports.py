"""What the benchmark loads: never JAX nor the JAX package (top-level
names compared whole: ``soccernerfs_tpu_torch`` is not ``soccernerfs_tpu``);
the references load nothing of the port either."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "nerfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "soccernerfs_tpu"}
PORT = "soccernerfs_tpu_torch"


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location("nerfbench_run", BENCH / "run.py")
        run = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(run)
    finally:
        sys.path.remove(str(BENCH))
    assert set(run.FORBIDDEN) == FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules["soccernerfs_tpu_torch_x"] = sys
        sys.modules.pop("soccernerfs_tpu", None)
        assert "soccernerfs_tpu" not in run.forbidden_modules()
        sys.modules["soccernerfs_tpu.sub"] = sys
        assert "soccernerfs_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert PORT not in tops and "nerfbench" not in tops
    assert tops <= {"__future__", "contextlib", "itertools", "math", "typing", "numpy", "torch"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of a cell at a small size in a fresh process, then the
    modules it loaded; and the reference's own process alone."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from nerfbench.harness import cell as C, spec
from nerfbench.tests.tiny import TINY
line = C.run_cell("kplanes-view", 2**31 + 5, 0.2, False, "cpu", overrides=TINY)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": line["correct"], "tops": tops}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=ROOT)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert not set(res["tops"]) & FORBIDDEN, set(res["tops"]) & FORBIDDEN
    assert PORT in res["tops"]
    code = f"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("ref", {str(BENCH / 'reference' / 'k-planes.py')!r})
mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=ROOT)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {PORT, "nerfbench"})
