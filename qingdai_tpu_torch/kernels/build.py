"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``*.cu`` source compiles to an object with ``nvcc -gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC --fmad=false
-c``, all of them in parallel, and the objects link into one shared library
with a plain C interface. ``--fmad=false`` keeps nvcc from contracting a
multiply and an add into one FMA, so each kernel performs the same sequence
of IEEE-rounded operations as its plain PyTorch version. The library goes to
``build/qingdai_tpu_torch/`` beside the package, named by a hash of the
sources, the shared headers (``*.cuh``) and the flags, and is built on first
use only.
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
              "-Xcompiler", "-fPIC", "--fmad=false"]

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# C signatures of the launchers; each returns cudaGetLastError() as an int
# (every launcher takes a member count and the inputs' member strides: the
# batched forms launch once for an ensemble's members, the single forms pass 1)
SIGNATURES = {
    "qd_median_pos": [_P, _LL, _I, _LL, _D, _P, _P, _P],
    "qd_advect_bilinear": [_P] * 6 + [_I] + [_LL] * 4 + [_I] * 3 + [_D] * 4 + [_P],
    "qd_hyper4": [_P] * 5 + [_I] + [_LL] * 3 + [_I] * 4 + [_D] * 4 + [_P],
    "qd_ocean_substeps": ([_P] * 10 + [_I, _I] + [_LL] * 4 + [_I] * 5 + [_D] * 9
                          + [_I, _D, _D, _I, _D, _P, _P]),
    "qd_phyto_transport": [_P] * 5 + [_I] + [_LL] * 4 + [_I] * 4 + [_D] * 6 + [_P],
    "qd_gauss_sep": [_P, _P, _I, _LL, _I, _I, _I, _P, _I, _I, _P],
}
# C signatures of the shape queries: the halos (rows, cols) and K4's tile count
QUERY_SIGNATURES = {
    "qd_hyper4_halo": [_P, _P],
    "qd_ocean_substeps_halo": [_I, _P, _P],
    "qd_ocean_substeps_tiles_f32": [_I, _I, _I, _P],
    "qd_ocean_substeps_tiles_f64": [_I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


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
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqd_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless a build of these exact sources exists.
    ``verbose`` adds ``-Xptxas -v`` and prints each compile's report of
    registers, shared memory and spills."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / (src.stem + ".o") for src in sources()]
        extra = ["-Xptxas", "-v"] if verbose else []
        compiles = [[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources(), objs)]
        # one nvcc per source, all started together; wait for every one
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        done = [(cmd, *proc.communicate(), proc.returncode) for cmd, proc in zip(compiles, procs)]
        for cmd, out, err, rc in done:
            _check(cmd, rc, out, err)
            if verbose:
                print(f"{Path(cmd[-1]).name}: {err.strip()}")
        tmp_lib = Path(tmpdir) / lib.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        _check(link, res.returncode, res.stdout, res.stderr)
        os.replace(tmp_lib, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _check(cmd, rc, out, err):
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}\n{err}")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every launcher's C signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for name, argtypes in QUERY_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib
