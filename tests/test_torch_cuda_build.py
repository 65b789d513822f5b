"""The CUDA build's library names: an edited source or shared header rebuilds.

vosk_tts_tpu_torch/utils/cuda_build.py names each built library by a hash
of its source, every ``csrc/*.cuh`` header and the nvcc flags, and builds
only when that file is missing. Nothing is compiled here (no nvcc): the
names alone are checked.
"""

from vosk_tts_tpu_torch.utils import cuda_build


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// helpers\n")
    kernel = cuda_build.CudaKernel("kernel.cu", "kernel_f32", [])
    first = kernel.library
    assert first.parent == tmp_path / "_build" and first.name.startswith("kernel-")
    assert kernel.library == first
    (tmp_path / "shared.cuh").write_text("// helpers, edited\n")
    second = kernel.library
    assert second != first
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert kernel.library not in (first, second)

