"""The key of a built CUDA library (ops/cuda/_build.py) covers the source
and every header it includes with quotes, so that editing a shared header
rebuilds every kernel that includes it.  No nvcc is needed."""

import pytest

pytest.importorskip("torch")

from adaptive_mcmc_tpu_torch.ops.cuda import _build  # noqa: E402


def _tree(tmp_path, header: str, nested: str):
    (tmp_path / "nested.cuh").write_text(nested)
    (tmp_path / "common.cuh").write_text(
        '#pragma once\n#include "nested.cuh"\n' + header)
    src = tmp_path / "kernel.cu"
    src.write_text('#include "common.cuh"\n#include <stdint.h>\n'
                   'extern "C" int f() { return 0; }\n')
    return src


def test_digest_changes_when_an_included_header_changes(tmp_path):
    src = _tree(tmp_path, "// v1\n", "// n1\n")
    first = _build.source_digest(src)
    assert _build.source_digest(src) == first
    _tree(tmp_path, "// v2\n", "// n1\n")
    second = _build.source_digest(src)
    assert second != first
    _tree(tmp_path, "// v2\n", "// n2\n")
    assert _build.source_digest(src) not in (first, second)


def test_sources_follow_quoted_includes_once():
    for name in ("arwmh_fused", "asss_fused"):
        paths = _build._sources(_build.CSRC / f"{name}.cu")
        assert [p.name for p in paths] == [f"{name}.cu", "common.cuh"]
    assert [p.name for p in _build._sources(_build.CSRC / "chol_update.cu")] \
        == ["chol_update.cu"]


def test_parse_ptxas_report():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelIN3amt5KidiqEEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelIN3amt5KidiqEEvv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 600 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3potv' for 'sm_90a'
ptxas info    : Function properties for _Z3potv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 380 bytes cmem[0]
"""
    assert _build.parse_ptxas(text) == [
        "_Z6kernelIN3amt5KidiqEEvv: 255 registers, 8-byte stack frame, "
        "4 bytes spill stores, 4 bytes spill loads",
        "_Z3potv: 40 registers, 0-byte stack frame, 0 bytes spill stores, "
        "0 bytes spill loads",
    ]
