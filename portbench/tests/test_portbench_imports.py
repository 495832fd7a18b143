"""No JAX and no JAX package in anything the benchmark runs, and nothing
of the program in the reference: top-level module names compared whole
(the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import spec

JAX_SIDE = {"jax", "jaxlib", "flax", "cold_compress_tpu"}
PROGRAM = "cold_compress_tpu_torch"

RUN_TINY = """
import sys, torch
torch.set_num_threads(1)
from portbench import run
from portbench.tests import tiny
run.run_cell(tiny.cell(batch=4, bias=True), 3, 0.2, True, device="cpu", control=True)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE_ONLY = """
import sys, torch
from portbench.tests import tiny
c = tiny.cell()
arch = c.arch
ref = arch.Reference(c.dims, arch.make_weights(c.dims, 1, "cpu"), c.traffic["cache"],
                     checked=arch.checked_layer(c.dims))
ref.follow([[7] * 70], [[9, 10, 11]])
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def top_level_loaded(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_side_module():
    loaded = top_level_loaded(RUN_TINY)
    assert PROGRAM in loaded
    assert not loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    loaded = top_level_loaded(REFERENCE_ONLY)
    assert not loaded & (JAX_SIDE | {PROGRAM})


def imports_of(path: Path, skip: tuple = ()) -> set:
    """Top-level names a file imports, leaving out the bodies of the
    functions named in ``skip``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in skip:
            node.body = []
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_names_the_jax_side():
    for path in spec.HERE.rglob("*.py"):
        assert not imports_of(path) & JAX_SIDE, path


def test_reference_check_and_weights_import_nothing_of_the_program():
    """Nor does an architecture module, but for its ``port_config``, which
    builds the program's ``ModelConfig`` and which the check never calls."""
    for path in [*(spec.HERE / "reference").glob("*.py"), spec.HERE / "check.py",
                 spec.HERE / "weights.py", spec.HERE / "roofline.py", spec.HERE / "traffic.py",
                 spec.HERE / "spec.py"]:
        assert PROGRAM not in imports_of(path), path
    for path in (spec.HERE / "arch").glob("*.py"):
        assert PROGRAM not in imports_of(path, skip=("port_config",)), path
