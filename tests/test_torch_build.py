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
