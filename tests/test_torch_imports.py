"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package ``repro``, and neither do ``chip_smoke.py`` and
``profile_serving.py``."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    names = _modules()
    for name in ("repro_torch.serving.core", "repro_torch.launch.serve",
                 "repro_torch.analysis.flops", "repro_torch.core.offload"):
        assert name in names
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m])\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "profile_serving.py"]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_kernel_sources_are_listed_for_the_build():
    from repro_torch.kernels import build
    sources = {str(PKG / s) for s in build.SOURCES.values()}
    assert sources == {str(p) for p in PKG.rglob("csrc/*.cu")}
    for name in build.SOURCES:
        assert build.lib_path(name).parent == PKG / "build"
