"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package ``repro``, and neither do ``chip_smoke.py``,
``profile_serving.py``, ``attn_bench.py`` and ``kernels_bench.py``."""
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


SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "profile_serving.py",
           ROOT / "attn_bench.py", ROOT / "kernels_bench.py"]


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


def test_library_name_covers_included_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header renames the library of every source
    that includes it (directly or through another header), so no stale
    ``.so`` is reused; an unrelated header does not."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "outer.cuh"\nint a;\n')
    (csrc / "outer.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// v1\n")
    (csrc / "other.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "PKG_DIR", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"a": "csrc/a.cu"})
    assert [p.name for p in build.source_files(csrc / "a.cu")] == [
        "a.cu", "outer.cuh", "inner.cuh"]
    before = build.lib_path("a")
    (csrc / "other.cuh").write_text("// v2\n")
    assert build.lib_path("a") == before
    (csrc / "inner.cuh").write_text("// v2\n")
    assert build.lib_path("a") != before
    # the port's two attention sources include the shared mainloop
    monkeypatch.undo()
    for name in ("fastattn_fwd", "paged_prefill"):
        files = build.source_files(PKG / build.SOURCES[name])
        assert PKG / "kernels/fastattn/csrc/attn_sm90.cuh" in files


def test_cached_library_reports_its_build_log(tmp_path, monkeypatch):
    """A library built earlier reports the ``-Xptxas -v`` log kept beside
    it, so a check of that log does not pass on an empty one."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "PKG_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "SOURCES", {"a": "a.cu"})
    (tmp_path / "a.cu").write_text("int a;\n")
    (tmp_path / "build").mkdir()
    lib = build.lib_path("a")
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 8 registers\n")
    report = build.build_all(["a"])
    assert report["a"]["cached"]
    assert report["a"]["log"] == "ptxas info    : Used 8 registers\n"
