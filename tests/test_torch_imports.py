"""The port imports nothing of JAX: every module of src/fastmatch_tpu_torch/
and chip_smoke.py, parsed with ``ast``, may not import ``jax``, ``jaxlib``
or the JAX package ``fastmatch_tpu`` (not even its JAX-free modules), by
``import``, ``from ... import``, ``__import__`` or ``importlib.import_module``.
"""

import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PACKAGE = os.path.join(ROOT, "src", "fastmatch_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "fastmatch_tpu")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(PACKAGE):
        out += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(source: str):
    """(line, module) of every import in ``source``, static or dynamic
    (``__import__``/``import_module`` with a literal name)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else fn.attr if isinstance(
                fn, ast.Attribute) else None
            if name in ("__import__", "import_module") and isinstance(node.args[0].value, str):
                found.append((node.lineno, node.args[0].value))
    return found


@pytest.mark.parametrize("path", _files())
def test_no_jax_import(path):
    with open(os.path.join(ROOT, path)) as fh:
        bad = [(line, m) for line, m in imported_modules(fh.read()) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_the_check_sees_every_form():
    src = ("import jax\nimport numpy, jaxlib.xla_client\nfrom fastmatch_tpu.core import lie\n"
           "from fastmatch_tpu_torch.core import lie\nimport importlib\n"
           "importlib.import_module('jax.numpy')\n__import__('fastmatch_tpu')\n"
           "from . import sibling\n")
    bad = [m for _, m in imported_modules(src) if _forbidden(m)]
    assert bad == ["jax", "jaxlib.xla_client", "fastmatch_tpu.core", "jax.numpy",
                   "fastmatch_tpu"]
    assert len(_files()) > 40
