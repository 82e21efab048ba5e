"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
msnv_tpu (top-level names compared whole: msnv_tpu_torch is the port), and
the plain reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

import h100bench_tiny as tiny

BANNED = {"jax", "jaxlib", "flax", "msnv_tpu"}
FILES = sorted(p for p in (tiny.REPO / "h100_bench").rglob("*.py")
               if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_banned_import_in_the_sources():
    for path in FILES:
        assert not set(_imports(path)) & BANNED, path


def test_reference_imports_nothing_of_the_port():
    for path in (tiny.REPO / "h100_bench/reference").glob("*.py"):
        assert "msnv_tpu_torch" not in set(_imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); "
            "import h100_bench.reference.samplernn, "
            "h100_bench.reference.philox; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (BANNED | {"msnv_tpu_torch"})


def test_a_run_loads_no_banned_module(tmp_path):
    """A whole run of a tiny cell in a fresh process, its modules read after
    the window; the prefix msnv_tpu of msnv_tpu_torch is no match."""
    root = tiny.build(tmp_path)
    code = ("import sys, json; sys.path.insert(0, %r); "
            "from h100_bench import harness; "
            "harness.run_cell('tiny.gen', 5, 0.2, False, 'cpu', "
            "__import__('pathlib').Path(%r)); "
            "print(json.dumps([sorted({m.split('.')[0] for m in "
            "sys.modules}), harness.banned_modules()]))"
            % (str(tiny.REPO), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.splitlines()[-1]
    loaded, banned = json.loads(out)
    assert "msnv_tpu_torch" in loaded
    assert not set(loaded) & BANNED
    assert banned == []
