"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``decomp_tpu_torch/_build/`` on first use,
then loaded with ``ctypes``. The library's file name carries a hash of
the source, the shared headers and the flags, so an edited source or
header rebuilds and a stale library is never loaded. ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside the library as ``<library>.log``.

Nothing here runs at import: the CPU tests import every module, and
this machine class has no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``. Its name hashes the source, every
    shared header ``csrc/*.cuh`` (a source may include any of them) and
    the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already built; return the library's path. Raises
    RuntimeError with nvcc's output on any compiler error."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}.cu:\n{proc.stdout}\n{proc.stderr}")
    Path(str(out) + ".log").write_text(
        f"# {' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n"
        + proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first call)."""
    return ctypes.CDLL(str(build(name)))
