"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``ops/csrc/`` have a plain C interface, so they compile in
seconds with ``nvcc`` alone (no PyTorch headers): one ``nvcc -c`` per source,
all started together, then one link into a shared library under
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
SOURCES = (CSRC / "mha.cu", CSRC / "mha_bwd.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    The nvcc logs (ptxas registers, shared memory, spills) are kept beside it."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objects)
        ]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            stdout, stderr = proc.communicate()
            logs.append(f"== {src.name}\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{stderr}")
        target = Path(tmp) / lib.name
        if not failed:
            proc = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(target), *map(str, objects)],
                capture_output=True, text=True,
            )
            logs.append(f"== link\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
        lib.with_suffix(".log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(target, lib)  # atomic: a concurrent loader never sees half a file
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
    lib.acl_mha_bwd_smem_bytes.argtypes = [i, i]
    lib.acl_mha_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.acl_mha_qkv_bwd.argtypes = [i, p, i, i, p, p, i, i, i, i, i, f, p]
    lib.acl_mha_qkv_bwd.restype = i
    lib.acl_mha_bld_bwd.argtypes = [i, p, i, i, p, i, i, p, i, i, p, i, i, p, p, p, i, i, i, i, i, f, p]
    lib.acl_mha_bld_bwd.restype = i
    return lib
