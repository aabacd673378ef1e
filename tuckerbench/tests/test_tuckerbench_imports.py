"""Nothing the benchmark runs loads JAX, the JAX package, its runner or the
verification script; the reference loads not even the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from _tiny import ROOT

BENCH = ROOT / "tuckerbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder: Path) -> list[Path]:
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(BENCH), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = _top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = _top_level_imports(path) & (FORBIDDEN | {"repro_torch"})
    assert not bad, f"{path} imports {bad}"
    # nor a benchmark module that does
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("tuckerbench"):
            target = BENCH / (node.module.split(".", 1)[1].replace(".", "/")
                              + ".py")
            assert "repro_torch" not in _top_level_imports(target)


def test_the_whole_name_is_compared():
    sys.path.insert(0, str(ROOT))
    from tuckerbench.harness import FORBIDDEN as harness_forbidden

    assert set(harness_forbidden) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_a_tiny_run_loads_none_of_them():
    """A whole tiny run on the CPU in a fresh process (the test process has
    JAX loaded by the repository's conftest)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
        "from _tiny import run_tiny\n"
        "res = run_tiny('nell2.lite.p4')\n"
        "from tuckerbench.harness import forbidden_modules\n"
        "print(json.dumps({'correct': res['correct'],"
        " 'loaded': forbidden_modules(),"
        " 'repro_torch': 'repro_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "loaded": [], "repro_torch": True}
