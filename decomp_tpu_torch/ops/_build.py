"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``decomp_tpu_torch/_build/`` on first use,
then loaded with ``ctypes``. The library's file name carries a hash of
the source, the shared headers and the flags, so an edited source or
header rebuilds and a stale library is never loaded. ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside the library as ``<library>.log``.

A built library also travels in a solver artifact (``utils.aot``):
``recording`` collects the libraries that a solve launches, and
``install`` puts a carried library where ``build`` finds it, so that a
machine without ``nvcc`` loads it instead of compiling.

Nothing here runs at import: the CPU tests import every module, and
this machine class has no ``nvcc``.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
import time
from pathlib import Path

from decomp_tpu_torch.utils.exceptions import DecompError

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")
#: The compute capability that ``sm_90a`` code runs on, and only on.
CAPABILITY = (9, 0)
_LIBRARY_NAME = re.compile(r"lib(?P<src>[A-Za-z0-9_]+)-[0-9a-f]{16}\.so")
# The sets of the active ``recording`` blocks.
_recordings = []


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


@contextlib.contextmanager
def recording():
    """Collect, in the set this yields, the names of the sources
    (``csrc/<name>.cu``) whose libraries the launches made inside the
    block go through, libraries loaded before the block included."""
    seen = set()
    _recordings.append(seen)
    try:
        yield seen
    finally:
        _recordings.remove(seen)


def reached(name: str) -> None:
    """Note, in every active ``recording``, a launch through the library
    of ``csrc/<name>.cu``. The kernels' wrappers call it at each launch."""
    for seen in _recordings:
        seen.add(name)


def install(name: str, blob: bytes, sha256: str) -> Path:
    """Put a built library carried elsewhere (``blob``, whose file name was
    ``name``) where ``build`` finds it, unless a library of that name is
    already built; return its path. Raises ``DecompError`` when the bytes'
    digest is not ``sha256``, or when ``name`` is not this package's
    ``library_path`` of a source in ``csrc/``: such a library was built
    from other sources, headers or flags. Written atomically, as
    ``build`` writes."""
    if hashlib.sha256(blob).hexdigest() != sha256:
        raise DecompError(f"library {name}: its bytes do not match their "
                          "sha256 digest")
    match = _LIBRARY_NAME.fullmatch(name)
    src = match and match["src"]
    if not src or not (SRC_DIR / f"{src}.cu").exists():
        raise DecompError(f"library {name} was not built from a source of "
                          f"this package ({SRC_DIR})")
    out = library_path(src)
    if out.name != name:
        raise DecompError(f"library {name} was built from other sources, "
                          f"headers or flags than this package's {out.name}")
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, out)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return out
