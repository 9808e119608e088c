"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch_kernels/lib<name>-<digest>.so`` under the repo
root (git-ignored), at first use.  The digest covers the source and the
flags, so an edited source is rebuilt and an old library never loaded.
Nothing here includes PyTorch's headers, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "ENTRY_POINTS", "NVCC_FLAGS", "SOURCES", "build",
           "library_path", "load_library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# sm_90a (not sm_90): the Hopper-only instructions that later versions of
# the kernels use exist only for that target.  -Xptxas -v puts registers
# and shared memory per kernel into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Every source and the kernel entry points its library exports: what
# ``chip_smoke.py`` builds (one nvcc per source) and checks is there.
ENTRY_POINTS = {
    "flash_attention": ("repro_flash_attention_fwd", "repro_flash_attention_fwd_wgmma",
                        "repro_flash_attention_bwd", "repro_flash_attention_bwd_wgmma"),
    "rwkv_wkv": ("repro_wkv_fwd", "repro_wkv_fwd_chunked", "repro_wkv_bwd",
                 "repro_wkv_bwd_chunked"),
    "adamw": ("repro_adamw_sumsq", "repro_adamw_update"),
}
SOURCES = tuple(ENTRY_POINTS)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` as it is now is built."""
    return _paths(name)[1]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current library exists.

    Raises if ``nvcc`` fails; returns its log ("" if nothing was built).
    """
    src, out = _paths(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)      # atomic: readers see no half-written file
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu``, compiled first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
