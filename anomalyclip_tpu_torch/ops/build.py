"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``ops/csrc/`` have a plain C interface, so they compile in
seconds with ``nvcc`` alone (no PyTorch headers): one ``nvcc -c`` per source,
all started together, then one link into a shared library under
``<repo>/build/kernels/``. The library's name carries a hash of the sources, the
header they share and the flags: a changed source builds a new library at its
first use, and an unchanged one is loaded as it is. Nothing is built when this
module is imported.
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
SOURCES = (
    CSRC / "mha.cu", CSRC / "mha_bwd.cu", CSRC / "mha_long.cu", CSRC / "mha_blocked_bwd.cu",
    CSRC / "mha_probe.cu", CSRC / "mha_tc.cu", CSRC / "mha_tc_bwd.cu", CSRC / "mha_tf32.cu",
    CSRC / "mha_tf32_bwd.cu", CSRC / "mha_bld_tf32.cu", CSRC / "mha_whole_tf32_bwd.cu",
)
# attention_common.cuh is included by every source, tensor_core.cuh by the
# six tensor-core ones
HEADERS = (CSRC / "attention_common.cuh", CSRC / "tensor_core.cuh")
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
    for src in (*SOURCES, *HEADERS):
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
    lib.acl_mha_qtile_smem_bytes.argtypes = [i, i, i]
    lib.acl_mha_qtile_smem_bytes.restype = ctypes.c_size_t
    lib.acl_flash_smem_bytes.argtypes = [i, i]
    lib.acl_flash_smem_bytes.restype = ctypes.c_size_t
    lib.acl_mha_qtile_fwd.argtypes = [i, p, i, i, p, i, i, p, i, i, i, i, f, p]
    lib.acl_mha_qtile_fwd.restype = i
    lib.acl_flash_fwd.argtypes = [i, p, i, i, p, i, i, p, i, i, p, p, i, i, i, i, f, p]
    lib.acl_flash_fwd.restype = i
    ptrs, strides = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)
    lib.acl_blocked_bwd_smem_bytes.argtypes = [i, i]
    lib.acl_blocked_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.acl_blocked_dq.argtypes = [i, ptrs, strides, p, p, p, i, i, i, i, i, i, f, p]
    lib.acl_blocked_dq.restype = i
    lib.acl_blocked_dkv.argtypes = [i, ptrs, strides, p, p, p, i, i, i, i, i, f, p]
    lib.acl_blocked_dkv.restype = i
    s, z = ctypes.c_int64, ctypes.c_size_t
    # the tensor-core kernel (mha_tc.cu): K1 and K6 per operand a pointer and
    # 64-bit batch and row strides; K8 the pointer and (batch, head, row) stride
    # arrays for q, k, v and the output, as the backward pair's
    lib.acl_mha_tc_smem_bytes.argtypes = [i]
    lib.acl_mha_tc_smem_bytes.restype = z
    lib.acl_mha_tc_blocks_per_sm.argtypes = [i, i]
    lib.acl_mha_tc_blocks_per_sm.restype = i
    lib.acl_mha_qkv_tc_fwd.argtypes = [p, s, s, p, i, i, i, i, i, f, p]
    lib.acl_mha_qkv_tc_fwd.restype = i
    lib.acl_mha_qtile_tc_fwd.argtypes = [p, s, s, p, s, s, p, i, i, i, i, f, p]
    lib.acl_mha_qtile_tc_fwd.restype = i
    lib.acl_flash_tc_fwd.argtypes = [ptrs, strides, p, i, i, i, i, i, f, p]
    lib.acl_flash_tc_fwd.restype = i
    # the tensor-core backward pair (mha_tc_bwd.cu): the arguments of
    # acl_blocked_dq and acl_blocked_dkv without the dtype and the row sum
    lib.acl_blocked_bwd_tc_smem_bytes.argtypes = [i, i]
    lib.acl_blocked_bwd_tc_smem_bytes.restype = z
    lib.acl_blocked_bwd_tc_blocks_per_sm.argtypes = [i, i]
    lib.acl_blocked_bwd_tc_blocks_per_sm.restype = i
    lib.acl_blocked_dq_tc.argtypes = [ptrs, strides, p, p, i, i, i, i, i, i, f, p]
    lib.acl_blocked_dq_tc.restype = i
    lib.acl_blocked_dkv_tc.argtypes = [ptrs, strides, p, p, i, i, i, i, i, f, p]
    lib.acl_blocked_dkv_tc.restype = i
    # the split-TF32 kernel (mha_tf32.cu): each entry's arguments as the
    # tensor-core kernel's
    lib.acl_mha_tf32_smem_bytes.argtypes = [i]
    lib.acl_mha_tf32_smem_bytes.restype = z
    lib.acl_mha_tf32_blocks_per_sm.argtypes = [i]
    lib.acl_mha_tf32_blocks_per_sm.restype = i
    lib.acl_mha_qkv_tf32_fwd.argtypes = lib.acl_mha_qkv_tc_fwd.argtypes
    lib.acl_mha_qkv_tf32_fwd.restype = i
    lib.acl_flash_tf32_fwd.argtypes = lib.acl_flash_tc_fwd.argtypes
    lib.acl_flash_tf32_fwd.restype = i
    lib.acl_mha_qtile_tf32_fwd.argtypes = lib.acl_mha_qtile_tc_fwd.argtypes
    lib.acl_mha_qtile_tf32_fwd.restype = i
    # the split-TF32 backward pair (mha_tf32_bwd.cu): the arguments of the
    # tensor-core pair's entries
    lib.acl_blocked_bwd_tf32_smem_bytes.argtypes = [i, i]
    lib.acl_blocked_bwd_tf32_smem_bytes.restype = z
    lib.acl_blocked_bwd_tf32_blocks_per_sm.argtypes = [i, i]
    lib.acl_blocked_bwd_tf32_blocks_per_sm.restype = i
    lib.acl_blocked_dq_tf32.argtypes = lib.acl_blocked_dq_tc.argtypes
    lib.acl_blocked_dq_tf32.restype = i
    lib.acl_blocked_dkv_tf32.argtypes = lib.acl_blocked_dkv_tc.argtypes
    lib.acl_blocked_dkv_tf32.restype = i
    # the split-TF32 whole-head kernels (mha_bld_tf32.cu): K2 and K4 in fp32, per
    # operand a pointer and 64-bit batch and row strides
    lib.acl_mha_bld_tf32_smem_bytes.argtypes = [i, i, i]
    lib.acl_mha_bld_tf32_smem_bytes.restype = z
    lib.acl_mha_bld_tf32_blocks_per_sm.argtypes = [i, i, i]
    lib.acl_mha_bld_tf32_blocks_per_sm.restype = i
    lib.acl_mha_bld_tf32_fwd.argtypes = [p, s, s, p, s, s, p, s, s, p, i, i, i, i, i, f, p]
    lib.acl_mha_bld_tf32_fwd.restype = i
    lib.acl_mha_bld_tf32_bwd.argtypes = [p, s, s, p, s, s, p, s, s, p, s, s, p, p, p, i, i, i, i, i,
                                         f, p]
    lib.acl_mha_bld_tf32_bwd.restype = i
    # the split-TF32 whole-head backward at head dim 64 (mha_whole_tf32_bwd.cu):
    # K3 from the packed qkv (its 64-bit strides), g and the packed dqkv; K4 as
    # acl_mha_bld_tf32_bwd
    lib.acl_mha_whole_tf32_smem_bytes.argtypes = [i]
    lib.acl_mha_whole_tf32_smem_bytes.restype = z
    lib.acl_mha_whole_tf32_blocks_per_sm.argtypes = [i]
    lib.acl_mha_whole_tf32_blocks_per_sm.restype = i
    lib.acl_mha_qkv_whole_tf32_bwd.argtypes = [p, s, s, p, p, i, i, i, i, i, f, p]
    lib.acl_mha_qkv_whole_tf32_bwd.restype = i
    lib.acl_mha_bld_whole_tf32_bwd.argtypes = lib.acl_mha_bld_tf32_bwd.argtypes
    lib.acl_mha_bld_whole_tf32_bwd.restype = i
    # the probes (mha_probe.cu): dtype, residency, rows and warps, then per operand
    # a pointer and 64-bit batch and row strides
    lib.acl_probe_smem_bytes.argtypes = [i, i, i, i, i]
    lib.acl_probe_smem_bytes.restype = z
    lib.acl_probe_blocks_per_sm.argtypes = [i, i, i, i, i, z]
    lib.acl_probe_blocks_per_sm.restype = i
    lib.acl_probe_qkv_fwd.argtypes = [i, i, i, i, p, s, s, p, i, i, i, i, i, f, p]
    lib.acl_probe_qkv_fwd.restype = i
    lib.acl_probe_qtile_fwd.argtypes = [i, i, i, i, p, s, s, p, s, s, p, i, i, i, i, f, p]
    lib.acl_probe_qtile_fwd.restype = i
    lib.acl_probe_nosoftmax_fwd.argtypes = lib.acl_probe_qtile_fwd.argtypes
    lib.acl_probe_nosoftmax_fwd.restype = i
    lib.acl_probe_bld_fwd.argtypes = [i, i, i, i, p, s, s, p, s, s, p, s, s, p, i, i, i, i, i, f, p]
    lib.acl_probe_bld_fwd.restype = i
    lib.acl_parts_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.acl_parts_smem_bytes.restype = z
    lib.acl_parts_blocks_per_sm.argtypes = [i, i, i, i, z]
    lib.acl_parts_blocks_per_sm.restype = i
    lib.acl_mha_parts_fwd.argtypes = [i, i, i, i, i, p, s, s, p, s, s, p, s, s, p, i, i, i, i, f, p]
    lib.acl_mha_parts_fwd.restype = i
    return lib
