"""Nothing that the benchmark runs imports JAX or the JAX package, and
the reference imports nothing of the program: every import of every
module under rtbench/, compared by its top-level name, whole."""

import ast
from pathlib import Path

from rtbench.harness import common

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "raytracer_tpu"}
PROGRAM = "raytracer_tpu_torch"


def imports(path):
    """The top-level names that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): imports(p) & JAX_SIDE
             for p in sources()}
    assert not {k: v for k, v in found.items() if v}


def test_the_program_counts_as_its_own_name():
    # raytracer_tpu_torch begins with raytracer_tpu and is not it
    assert common.forbidden_modules({"raytracer_tpu_torch.core": 1,
                                     "rtbench": 1}) == []
    assert common.forbidden_modules({"raytracer_tpu.core.render": 1,
                                     "jax.numpy": 1, "jaxlib": 1}) == [
        "jax.numpy", "jaxlib", "raytracer_tpu.core.render"]


def test_the_reference_imports_nothing_of_the_program():
    ref = sorted((BENCH / "reference").rglob("*.py"))
    assert ref
    found = {str(p.relative_to(BENCH)): imports(p) for p in ref}
    assert not {k: v for k, v in found.items()
                if v & (JAX_SIDE | {PROGRAM})}
    allowed = {"__future__", "math", "numpy", "torch", "rtbench"}
    assert all(v <= allowed for v in found.values()), found


def test_the_scan_sees_every_kind_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom raytracer_tpu.core import x\n"
                 "from . import y\nimport raytracer_tpu_torch\n")
    assert imports(f) == {"jax", "raytracer_tpu", PROGRAM}
