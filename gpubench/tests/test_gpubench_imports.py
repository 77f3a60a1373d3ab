"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole, so ``rattle_tpu_torch`` is not ``rattle_tpu``."""

import ast
import os

import pytest

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rattle_tpu"}
GPUBENCH = os.path.join(ROOT, "gpubench")


def _modules():
    for d, _sub, files in os.walk(GPUBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every import in ``path``; relative imports count
    as ``gpubench``."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add(node.module.split(".")[0] if node.level == 0
                    else "gpubench")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, GPUBENCH))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    """The reference and what it reaches: the modes' modules, the format."""
    for rel in ("reference/cluster.py", "modes/cluster.py", "hpsio.py",
                "synth.py"):
        names = imported(os.path.join(GPUBENCH, rel))
        assert not names & {"rattle_tpu_torch", "torch"}, rel


def test_the_scan_sees_names_whole():
    names = imported(os.path.join(GPUBENCH, "harness.py"))
    assert "rattle_tpu_torch" in names and not names & FORBIDDEN
