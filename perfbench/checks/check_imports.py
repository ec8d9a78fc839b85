"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and the
reference (every architecture module) imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench.lib.files import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules(path: Path) -> set:
    """The dotted names of the modules `path` imports (relative imports
    resolved against its package)."""
    package = ".".join(path.relative_to(ROOT).parent.parts)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package.rsplit(".", node.level - 1)[0] if node.level else ""
            names.add(".".join(p for p in (base, node.module) if p))
    return names


def _imports(path: Path) -> set:
    return {name.split(".")[0] for name in _modules(path)}


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    """Architecture modules share helpers among themselves, and import
    nothing else but the standard library's few and torch."""
    for path in (BENCH / "reference").rglob("*.py"):
        others = {name for name in _modules(path)
                  if name != "perfbench.reference" and not name.startswith("perfbench.reference.")}
        assert {n.split(".")[0] for n in others} <= {"__future__", "contextlib", "copy", "typing",
                                                     "torch"}, path


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then the same look ``run.py``
    takes once its window has closed."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from perfbench.checks.tiny import tiny_cell\n"
        "from perfbench.run import loaded_forbidden, measure\n"
        "rec, metrics = measure(tiny_cell('olmoe-serve-wide', seconds=1.0), False)\n"
        "rec2, _ = measure(tiny_cell('dsc33b-prefill-code', seconds=1.0), False)\n"
        "assert rec.correct and rec2.correct and 'gen_tokens_per_s' in metrics\n"
        "print(loaded_forbidden())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"), str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_file_is_collected_by_the_repositorys_test_run():
    for path in BENCH.rglob("*.py"):
        assert not path.name.startswith("test_") and not path.name.endswith("_test.py"), path
