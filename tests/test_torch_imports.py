"""The import rule of the PyTorch port: adaptive_mcmc_tpu_torch and
chip_smoke.py import neither jax nor the JAX package adaptive_mcmc_tpu.
Each of the port's packages and top modules is imported in a fresh
interpreter, which must end with no such module loaded; and every .py file
of the port and chip_smoke.py is read with ast for such imports."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "adaptive_mcmc_tpu_torch"
MODULES = sorted(
    ["adaptive_mcmc_tpu_torch"]
    + [f"adaptive_mcmc_tpu_torch.{p.parent.name}"
       for p in PORT.glob("*/__init__.py")]
    + ["adaptive_mcmc_tpu_torch.ops.cuda"]
    + [f"adaptive_mcmc_tpu_torch.experiments.{m}"
       for m in ("cli", "compare_wasserstein", "gold_spread", "sweep")]
    + [f"adaptive_mcmc_tpu_torch.{p.stem}" for p in PORT.glob("*.py")
       if p.stem != "__init__"])
FORBIDDEN = ("jax", "jaxlib", "adaptive_mcmc_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("module", MODULES)
def test_fresh_import_loads_no_jax(module):
    code = ("import sys, importlib; importlib.import_module(%r); "
            "print(sorted(m for m in sys.modules if m in %r or "
            "any(m.startswith(f + '.') for f in %r)))"
            % (module, FORBIDDEN, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _imports(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
