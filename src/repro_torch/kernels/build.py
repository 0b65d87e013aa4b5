"""Build the port's CUDA kernels and load them with ctypes.

Each source in ``csrc/`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
         -shared -Xcompiler -fPIC -o <lib>.so csrc/<name>.cu

Libraries go to ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  ptxas' report (registers, shared memory,
spills) is kept beside each library as ``<lib>.log``.  A failed build raises
with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int

#: kernel source -> {C entry point: (argtypes, restype)}
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "fed_gather": {
        "fed_cohort_gather_launch":
            ([P, P, P, P, P, P, P, ctypes.c_longlong, I, I, I, I, P], I),
        "fed_cohort_gather_error_string": ([I], ctypes.c_char_p),
    },
    "fed_local_sgd": {
        "fed_local_sgd_mclr_launch":
            ([P] * 10 + [I] * 9 + [ctypes.c_float, ctypes.c_float, P], I),
        "fed_local_sgd_mclr_smem_bytes": ([I] * 5, ctypes.c_longlong),
        "fed_local_sgd_mclr_max_clusters": ([I] * 3 + [ctypes.c_longlong],
                                            I),
        "fed_local_sgd_mclr_error_string": ([I], ctypes.c_char_p),
    },
    "fed_local_sgd_dense": {
        "fed_local_sgd_dense_launch":
            ([P] * 14 + [I] * 10 + [ctypes.c_float, ctypes.c_float, P], I),
        "fed_local_sgd_dense_smem_bytes": ([I] * 6, ctypes.c_longlong),
        "fed_local_sgd_dense_max_clusters": ([I] * 3 + [ctypes.c_longlong],
                                             I),
        "fed_local_sgd_dense_error_string": ([I], ctypes.c_char_p),
    },
    "fed_compress": {
        "fed_compress_topk_q8_launch":
            ([P, P, P] + [I] * 6 + [ctypes.c_longlong, P], I),
        "fed_compress_topk_q8_smem_bytes": ([I] * 2, ctypes.c_longlong),
        "fed_compress_topk_q8_max_clusters": ([I, I, ctypes.c_longlong], I),
        "fed_compress_topk_q8_error_string": ([I], ctypes.c_char_p),
    },
    "flash_attention": {
        "flash_attention_fwd_launch":
            ([P] * 5 + [I] * 8 + [ctypes.c_float, I, P], I),
        "flash_attention_fwd_smem_bytes": ([I], ctypes.c_longlong),
        "flash_attention_fwd_error_string": ([I], ctypes.c_char_p),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch":
            ([P] * 10 + [I] * 8 + [ctypes.c_float, I, P], I),
        "flash_attention_bwd_error_string": ([I], ctypes.c_char_p),
    },
    "fused_xent": {
        "fused_xent_fwd_launch": ([P] * 6 + [I] * 7 + [P], I),
        "fused_xent_fwd_error_string": ([I], ctypes.c_char_p),
    },
    "fused_xent_bwd": {
        "fused_xent_bwd_launch": ([P] * 11 + [I] * 7 + [P], I),
        "fused_xent_bwd_error_string": ([I], ctypes.c_char_p),
    },
    "selective_scan": {
        "selective_scan_fwd_launch": ([P] * 8 + [I] * 4 + [P], I),
        "selective_scan_fwd_error_string": ([I], ctypes.c_char_p),
    },
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the port's CUDA kernels are built from source at first use")
    return nvcc


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def nvcc_command(name: str, output: str, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", output, source_path(name)]


def build_all(names=tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every missing library of ``names``, one nvcc process per
    source, all started together.  Returns {name: build seconds} for the
    ones built (an up-to-date library is not rebuilt)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = {}
    for n in todo:
        tmp = f"{library_path(n)}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        procs[n] = (subprocess.Popen(
            nvcc_command(n, tmp, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), tmp, t0)
    seconds, failed = {}, []
    for n, (proc, tmp, t0) in procs.items():
        out, err = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n"
                          f"{out}{err}")
            continue
        with open(library_path(n)[:-3] + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, library_path(n))   # atomic: concurrent builders
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """ptxas' report for the current build of ``name`` ('' if absent)."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library for ``name``, built first if needed, with argtypes and
    restype declared for every entry point (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits)."""
    build_all((name,))
    lib = ctypes.CDLL(library_path(name))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if code:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
