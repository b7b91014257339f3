"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

The sources compile into one shared library with a plain C interface:
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC --fmad=false``. ``--fmad=false`` keeps nvcc from contracting
a multiply and an add into one FMA, so each kernel performs the same
sequence of IEEE-rounded operations as its plain PyTorch version. The
library goes to ``build/qingdai_tpu_torch/`` beside the package, named by a
hash of the sources and flags, and is built on first use only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qingdai_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false"]

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# C signatures of the launchers; each returns cudaGetLastError() as an int
SIGNATURES = {
    "qd_median_pos": [_P, _LL, _D, _P, _P],
    "qd_advect_bilinear": [_P, _P, _P, _P, _I, _I, _I, _P],
    "qd_hyper4": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _D, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqd_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every launcher's C signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
