"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and importing the port
leaves JAX out of ``sys.modules``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.kernels.ops, repro_torch.serve\n"
        "import repro_torch.models.transformer, repro_torch.models.convert\n"
        "import repro_torch.configs.granite_8b, repro_torch.kernels._build\n"
        "import repro_torch.configs.mamba2_2p7b, repro_torch.kernels.ssd\n"
        "import repro_torch.models.mamba_lm, repro_torch.models.ssd\n"
        "import repro_torch.core.shuffle, repro_torch.kernels.gemm\n"
        "import repro_torch.kernels.reduction, repro_torch.kernels.histogram\n"
        "import repro_torch.benchmarks.common, repro_torch.benchmarks.tablev\n"
        "import repro_torch.configs.granite_moe_3b_a800m\n"
        "import repro_torch.kernels.rmsnorm, repro_torch.kernels.attention\n"
        "import repro_torch.train, repro_torch.train.loop, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.parallel\n"
        "import repro_torch.launch.train\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
