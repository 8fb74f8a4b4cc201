"""The port stands alone: every module of ``repro_torch``, and
``chip_smoke.py``, imports with ``jax`` and the reference package ``repro``
blocked, and neither names them in an import statement."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(len(names))
"""

_IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|repro)\b",
                        re.MULTILINE)


def test_port_imports_with_jax_and_reference_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS, str(ROOT / "src"),
         str(ROOT)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20     # every module was imported


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_import_statements(path):
    assert not _IMPORT_RE.search(path.read_text()), path
