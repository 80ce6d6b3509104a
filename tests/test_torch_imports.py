"""The import rule of the PyTorch port: adaptive_mcmc_tpu_torch and
chip_smoke.py import neither jax nor the JAX package adaptive_mcmc_tpu,
and no module of the port loads matplotlib, pandas or seaborn when it is
imported.
Each of the port's packages and top modules is imported in a fresh
interpreter, which must end with no such module loaded; and every .py file
of the port and chip_smoke.py is read with ast for such imports, and for
string constants outside docstrings that name a path into the JAX
package's directory.  The port's vendored data (``models/_data``) equals
the JAX package's files byte for byte."""

import ast
import re
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
       for m in ("cli", "compare_wasserstein", "gold_spread", "lr_sweep",
                 "moments_parity", "sweep")]
    + [f"adaptive_mcmc_tpu_torch.analysis.{m}"
       for m in ("figures", "artifact_figures", "model_diagrams")]
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


def test_modules_import_no_matplotlib():
    """Every module above imports in one fresh interpreter without
    loading matplotlib: the figure modules import it where they draw, so
    they import on a machine without it (the card's)."""
    code = ("import sys, importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('matplotlib', 'pandas', 'seaborn')))"
            % (MODULES,))
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
                         [ROOT / "chip_smoke.py",
                          ROOT / "tests" / "_torch_distributed_worker.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# a path component "adaptive_mcmc_tpu" (not "adaptive_mcmc_tpu_torch");
# a "file.py:line" citation (chip_smoke.py's "replaces" of each kernel)
# is a label, not a path that code opens
JAX_DIR = re.compile(r"(^|[/\\])adaptive_mcmc_tpu($|[/\\])")
CITATION = re.compile(r"^[\w/]+\.py:\d+$")


def _path_constants(path: Path) -> list:
    """String constants of a source file that name a path into the JAX
    package's directory, docstrings left out."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs and JAX_DIR.search(node.value)
            and not CITATION.match(node.value)]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_path_into_the_jax_package(path):
    bad = _path_constants(path)
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_path_rule_catches_a_path_into_the_jax_package(tmp_path):
    """The rule above finds the form the port used to read the diamonds
    data by (a path built from the repo root), and passes docstrings,
    comments and the port's own name."""
    src = tmp_path / "m.py"
    src.write_text(
        '"""Reads adaptive_mcmc_tpu/models/_gold in its docstring."""\n'
        "# adaptive_mcmc_tpu/models in a comment\n"
        "from pathlib import Path\n"
        "ROOT = Path(__file__).parents[2]\n"
        'A = ROOT / "adaptive_mcmc_tpu" / "models"\n'
        'B = ROOT / "adaptive_mcmc_tpu_torch" / "models"\n'
        'C = f"{ROOT}/adaptive_mcmc_tpu/models/_gold"\n'
        'D = "adaptive_mcmc_tpu/ops/pallas/chol_update.py:107"\n')
    assert sorted(_path_constants(src)) == [
        "/adaptive_mcmc_tpu/models/_gold", "adaptive_mcmc_tpu"]


@pytest.mark.parametrize("jax_file,port_file", [
    ("_diamonds_stats.npz", "_diamonds_stats.npz"),
    ("_gold/diamonds.npy", "diamonds.npy"),
])
def test_vendored_data_equals_the_jax_files(jax_file, port_file):
    jax_path = ROOT / "adaptive_mcmc_tpu" / "models" / jax_file
    port_path = PORT / "models" / "_data" / port_file
    assert port_path.read_bytes() == jax_path.read_bytes(), port_file
