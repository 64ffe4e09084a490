"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``ops/csrc/`` have a plain C interface, so they compile in
seconds with ``nvcc`` alone (no PyTorch headers) into one shared library under
``<repo>/build/kernels/``. The library's name carries a hash of the sources and
flags: a changed source builds a new library at its first use, and an unchanged
one is loaded as it is. Nothing is built when this module is imported.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "mha.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libacl_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library built from them exists -> its path.
    The nvcc log (ptxas registers, shared memory, spills) is kept beside it."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(out), *map(str, SOURCES)],
            capture_output=True, text=True,
        )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(out, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry's signature."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.acl_mha_smem_bytes.argtypes = [i, i]
    lib.acl_mha_smem_bytes.restype = ctypes.c_size_t
    lib.acl_mha_qkv_fwd.argtypes = [i, p, i, i, p, i, i, i, i, i, f, p]
    lib.acl_mha_qkv_fwd.restype = i
    lib.acl_mha_bld_fwd.argtypes = [i, p, i, i, p, i, i, p, i, i, p, i, i, i, i, i, f, p]
    lib.acl_mha_bld_fwd.restype = i
    return lib
