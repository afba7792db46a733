"""The port stands alone: no module of goliath_torch/ (its native/ zip
reader included), not chip_smoke.py and not the capture writer it imports
(tests/goliath_capture.py) imports JAX, orbax or the JAX package (the
card's machine has none of them; the port reads orbax checkpoints through
tensorstore). Read from
the sources with ``ast``; this file imports neither package itself.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "goliath_tpu")
# chip_smoke.py imports the capture writer of the tests, so it is checked too
SOURCES = sorted(ROOT.glob("goliath_torch/**/*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "goliath_capture.py"]


def forbidden_imports(source: str):
    """(line, module) of every import of a FORBIDDEN package, at any depth
    of the module (functions, branches and ``try`` blocks included)."""
    hits = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        hits += [(node.lineno, n) for n in names
                 if n.split(".")[0] in FORBIDDEN]
    return hits


def test_the_port_has_sources_to_check():
    assert len(SOURCES) > 40
    assert (ROOT / "goliath_torch" / "__init__.py") in SOURCES
    assert (ROOT / "goliath_torch" / "native" / "zipio.py") in SOURCES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    hits = forbidden_imports(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


@pytest.mark.parametrize("line", [
    "import jax", "import jax.numpy as jnp", "from jax import lax",
    "import goliath_tpu.utils.hdr", "from goliath_tpu.utils import hdr",
    "def f():\n    from goliath_tpu import models",
    "try:\n    import flax\nexcept ImportError:\n    pass",
    "import orbax.checkpoint as ocp",
])
def test_the_guard_finds_each_form(line):
    assert forbidden_imports(line)


@pytest.mark.parametrize("line", [
    "import jaxtyping_free_module", "from . import jax",
    "import goliath_torch.utils.hdr", "x = 'import jax'",
])
def test_the_guard_passes_other_imports(line):
    assert not forbidden_imports(line)
