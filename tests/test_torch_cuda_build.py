"""The port's kernel build (``ngp_tpu_torch/ops/cuda_build.py``) names each
library by a hash of what it is compiled from: its source, the headers of
``csrc/`` that a source may include, and the flags. An edited header must
give a new name, or a checkout would load a library built from the old
header. Runs on the CPU: naming a library compiles nothing."""

import pytest

from ngp_tpu_torch.ops import cuda_build


def _edit(tmp_path, change: str):
    if change == "header edited":
        (tmp_path / "rows.cuh").write_text("// rows, edited\n")
    elif change == "header added":
        (tmp_path / "more.cuh").write_text("// another header\n")
    elif change == "source edited":
        (tmp_path / "k.cu").write_text('#include "rows.cuh"\n// edited\n')


@pytest.mark.parametrize("change", ["header edited", "header added", "source edited"])
def test_library_path_follows_source_and_headers(tmp_path, monkeypatch, change):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "KERNELS", [])
    (tmp_path / "k.cu").write_text('#include "rows.cuh"\n')
    (tmp_path / "rows.cuh").write_text("// rows\n")
    kernel = cuda_build.CudaKernel("k.cu", {}, ("k",))
    first = kernel.lib_path()
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("libk-")
    assert kernel.lib_path() == first  # the same bytes name the same library
    _edit(tmp_path, change)
    assert kernel.lib_path() != first
