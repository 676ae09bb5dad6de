"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The build happens at first
use, into ``build/kernels/`` at the root of the checkout; the library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  ``nvcc``'s register
and shared-memory report (``-Xptxas -v``) is kept beside the library as
``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds each source took to compile in this process (0.0 when an
#: existing library was loaded)
build_seconds: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path.  Raises with nvcc's output when the build fails."""
    out = library_path(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[name] = time.perf_counter() - t0
    return out


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong
#: C signatures: name -> (argtypes, restype); every library also exports
#: ``<name>_error_string``
_SIGNATURES = {
    "sdv": {
        "sdv_gemv": ([_PTR, _PTR, _PTR] + [_INT] * 10 + [_PTR], _INT),
        "sdv_gemm": ([_PTR, _PTR, _PTR] + [_INT] * 10 + [_PTR], _INT),
        "sdv_smem_bytes": ([_INT, _INT], _INT),
        "sdv_error_string": ([_INT], ctypes.c_char_p),
    },
    "sdv_wgmma": {
        "sdv_gemm_wgmma": ([_PTR, _PTR, _PTR] + [_INT] * 12 + [_PTR], _INT),
        "sdv_wgmma_smem_bytes": ([_INT, _INT], _INT),
        "sdv_wgmma_error_string": ([_INT], ctypes.c_char_p),
    },
    "bseg": {
        "bseg_conv2d": ([_PTR, _PTR, _PTR] + [_INT] * 20 + [_PTR], _INT),
        "bseg_error_string": ([_INT], ctypes.c_char_p),
    },
    "bseg1d": {
        "bseg_conv1d": ([_PTR, _PTR, _PTR] + [_INT] * 10 + [_PTR], _INT),
        "bseg1d_error_string": ([_INT], ctypes.c_char_p),
    },
    "packbits": {
        "pack_words": ([_PTR, _PTR, _I64] + [_INT] * 3 + [_PTR], _INT),
        "unpack_words": ([_PTR, _PTR, _I64] + [_INT] * 3 + [_PTR], _INT),
        "unpack_dequant": ([_PTR] * 3 + [_INT] * 9 + [_PTR], _INT),
        "packbits_error_string": ([_INT], ctypes.c_char_p),
    },
    "quant_matmul": {
        "quant_matmul": ([_PTR] * 6 + [_INT] * 7 + [_PTR], _INT),
        "quant_matmul_error_string": ([_INT], ctypes.c_char_p),
    },
}


def load(path: Path, name: str) -> ctypes.CDLL:
    """Load a library built from ``csrc/<name>.cu`` (or a copy of it)
    at ``path``, with ``name``'s C signatures."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.error_string = getattr(lib, f"{name}_error_string")
    return lib


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return load(build(name), name)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
