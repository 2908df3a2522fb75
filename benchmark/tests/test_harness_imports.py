"""The import rule: nothing the benchmark runs loads JAX, its libraries or
the JAX package `npe_tpu`, compared by whole top-level names (the port,
`npe_tpu_torch`, begins with the JAX package's name); the plain reference
and the yardstick import nothing of the program."""

import ast
import subprocess
import sys
import textwrap

import pytest

from benchmark import core

FILES = sorted(p for p in core.HERE.rglob("*.py") if "tests" not in p.relative_to(core.HERE).parts)


def imported(path):
    """Top-level names of every module a file imports, wherever it does."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(core.ROOT).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in ("reference", "yardstick")],
                         ids=lambda p: p.relative_to(core.ROOT).as_posix())
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert "npe_tpu_torch" not in imported(path)


@pytest.mark.parametrize("names,found", [
    (["npe_tpu_torch", "npe_tpu_torch.api", "jaxtyping", "flax_like"], []),
    (["npe_tpu.models.ian"], ["npe_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
])
def test_names_are_compared_whole(names, found):
    assert core.forbidden_modules(names) == found


def test_a_run_loads_none_of_them():
    """A whole cell run on the CPU, at a tiny width, in a process of its own."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(core.ROOT)!r})
        from benchmark import core
        from benchmark.tests.tiny import tiny
        run = core.Run("encdec-IANv1-fp32", 5, 0.5, 0, "cpu")
        run.config = tiny(run.config)
        run.traffic["batch"] = 4
        result = core.execute(run, time.perf_counter())
        print(core.forbidden_modules(), result["correct"])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
