"""The kernel build cache: a library is named by a hash of its source, the
headers the source includes with quotes, and the flags.  Nothing here calls
nvcc."""

import pytest

from desktop2stereo_tpu_torch.ops.kernels import attention as K2
from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def sources(tmp_path):
    """kernel.cu includes a.cuh, which includes sub/b.cuh; a system header
    and a commented-out name stay out."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "kernel.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\n// #include <b.cuh>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "sub/b.cuh"\nint a;\n')
    (tmp_path / "sub" / "b.cuh").write_text("#pragma once\nint b;\n")
    return tmp_path


def test_source_files_follow_quoted_includes(sources):
    lib = CudaLibrary(str(sources / "kernel.cu"), {})
    assert lib.source_files() == [sources / "kernel.cu", sources / "a.cuh",
                                  sources / "sub" / "b.cuh"]


@pytest.mark.parametrize("edited", ["kernel.cu", "a.cuh", "sub/b.cuh"])
def test_library_path_changes_with_any_included_file(sources, edited):
    lib = CudaLibrary(str(sources / "kernel.cu"), {})
    before = lib.library_path()
    assert lib.library_path() == before  # unchanged files, unchanged name
    path = sources / edited
    path.write_text(path.read_text() + "int edited;\n")
    after = lib.library_path()
    assert after != before and after.name.startswith("kernel-")


def test_library_path_changes_with_flags(sources):
    plain = CudaLibrary(str(sources / "kernel.cu"), {})
    flagged = CudaLibrary(str(sources / "kernel.cu"), {}, extra_flags=("-fmad=false",))
    assert plain.library_path() != flagged.library_path()


@pytest.mark.parametrize("kernel", [K2.KERNEL, K4.KERNEL], ids=["attention", "quant_matmul"])
def test_hopper_kernels_hash_the_shared_header(kernel):
    assert [p.name for p in kernel.source_files()] == [kernel.source.name, "hopper.cuh"]
