"""No run of the benchmark loads JAX or the JAX package: whole top-level
names are compared, so the port, whose name begins with the JAX
package's, passes."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

from benchmark.harness import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["adaptive_mcmc_tpu_torch",
                              "adaptive_mcmc_tpu_torch.kernels",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["adaptive_mcmc_tpu"]) == ["adaptive_mcmc_tpu"]
    assert forbidden_modules(["adaptive_mcmc_tpu.models", "jax.numpy",
                              "jaxlib", "flax.linen"]) == [
        "adaptive_mcmc_tpu.models", "flax.linen", "jax.numpy", "jaxlib"]


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for p in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(p) & {"jax", "jaxlib", "flax",
                                  "adaptive_mcmc_tpu"}, p


def test_reference_imports_nothing_of_the_port():
    for p in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "adaptive_mcmc_tpu_torch" not in _imports(p), p


def test_a_run_loads_no_jax_module():
    """A fresh process that loads the harness, every job kind and the
    port's modules a run drives has no forbidden module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.registry import Registry\n"
        "from benchmark import harness, run, faults, readings\n"
        "reg = Registry()\n"
        "for k in ('sample', 'grade'): reg.job_module(k)\n"
        "import adaptive_mcmc_tpu_torch\n"
        "import adaptive_mcmc_tpu_torch.experiments.runner\n"
        "import adaptive_mcmc_tpu_torch.experiments.evaluate\n"
        "import adaptive_mcmc_tpu_torch.parallel\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
