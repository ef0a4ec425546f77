"""``ops/cuda_build.py`` on the CPU, with a stand-in for nvcc: a library's
own flags follow the shared ones on nvcc's command line and key its build,
so that a library built with other flags is built again, not reused."""

from firewheel_tpu_torch import executor_mega
from firewheel_tpu_torch.ops import cuda_build
from firewheel_tpu_torch.ops.cuda_build import NVCC_FLAGS, CudaLibrary

# writes its arguments beside itself and an empty output file
FAKE_NVCC = """#!/bin/sh
echo "$@" > "$(dirname "$0")/argv"
while [ $# -gt 0 ]; do
  if [ "$1" = -o ]; then : > "$2"; fi
  shift
done
"""


def test_library_flags_reach_nvcc_and_key_the_build(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    plain = CudaLibrary("fw_probe", "noise.cu")
    split = CudaLibrary("fw_probe", "noise.cu", flags=("--split-compile=0",))
    assert plain.path() != split.path()
    split._finish(split._start(False), False)
    argv = (tmp_path / "argv").read_text().split()
    assert argv[:len(NVCC_FLAGS)] == list(NVCC_FLAGS)
    assert argv[len(NVCC_FLAGS)] == "--split-compile=0"
    assert split.path().exists() and not plain.path().exists()
    assert split._start(False) is None  # built: nothing to start
    # the megakernel's library (K2, K3) is the one built on every core
    assert executor_mega.LIBRARY.flags == ("--split-compile=0",)
