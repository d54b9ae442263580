"""Nothing the benchmark runs loads JAX, flax or the JAX package (compared
by whole top-level name: ``u2mkd_tpu_torch`` is the program), and the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from port_bench import cells

PKG = cells.PACKAGE_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "u2mkd_tpu"}


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not FORBIDDEN & set(_imported_tops(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert "u2mkd_tpu_torch" not in set(_imported_tops(path)), path
    code = ("import pkgutil, importlib, sys, port_bench.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, 'port_bench.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "import port_bench.compare, port_bench.weights, port_bench.gen\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & (FORBIDDEN | {"u2mkd_tpu_torch"})


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, torch\n"
            "from pathlib import Path\n"
            "torch.set_num_threads(1)\n"
            "from port_bench import session\n"
            "from port_bench.tests import tiny\n"
            f"cell = tiny.tiny_cell(Path({str(tmp_path)!r}), 'ours_star.request_6cam',"
            " pool=1, sampled=1)\n"
            "out = session.run(cell, 5, 0.5, False, torch.device('cpu'), 0.0)\n"
            "assert out['ctx'].calls >= 1\n"
            "print(session.forbidden_modules(), 'u2mkd_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from port_bench import session

    monkeypatch.setitem(sys.modules, "u2mkd_tpu_torch_like", sys)
    assert "u2mkd_tpu_torch_like" not in session.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib.xla" in session.forbidden_modules()
