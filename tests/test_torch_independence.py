"""The port (src/repro_torch) and chip_smoke.py import neither ``jax`` nor
anything of the JAX package ``repro`` or of ``benchmarks``: the machine
with the card has no JAX, and the port keeps its own copies."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    bad = _top_level_imports(path) & {"jax", "jaxlib", "repro", "benchmarks"}
    assert not bad, f"{path} imports {bad}"


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
BLOCK = ("jax", "jaxlib", "repro", "benchmarks")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCK]
assert not leaked, leaked
print("imported", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def test_every_module_imports_with_jax_and_reference_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device (this CPU machine), or outside a checkout,
    chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(script.parent))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
