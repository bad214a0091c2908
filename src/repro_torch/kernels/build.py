"""Build and load the hand-written CUDA kernels.

At first use the ``.cu`` sources under ``kernels/csrc/`` are compiled
for ``sm_90a`` with ``nvcc`` -- one process per source, all started
together -- and linked into one shared library with a plain C interface,
which is loaded with ``ctypes``.  The library lands in
``build/kernels/<hash>/`` at the root of the checkout (the hash covers
the sources and flags, so an edited source rebuilds).  A missing
``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("lowrank_matmul.cu", "branched_matmul.cu", "lowrank_matmul_q.cu",
           "branched_matmul_q.cu", "decode_attention_q.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libreprotorch_kernels.so"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile (if not built yet) and return ``(library path, ptxas
    report)`` -- the report lists each kernel's registers, shared memory
    and spills."""
    out = BUILD_ROOT / _digest()
    lib = out / LIB_NAME
    log = out / "ptxas.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    nvcc = nvcc_path()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = out / (Path(src).stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, objs, failed = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        report.append(f"== {src}\n{text}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(report))
    tmp = out / (LIB_NAME + ".tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", *objs, "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    log.write_text("\n".join(report))
    tmp.replace(lib)
    return lib, log.read_text()


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every C entry
    point's argument and return types declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lrk_lowrank_matmul.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.lrk_lowrank_matmul.restype = i
    lib.lrk_lowrank_smem.argtypes = [i, i, i]
    lib.lrk_lowrank_smem.restype = ctypes.c_size_t
    lib.lrk_branched_matmul.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i,
                                        p]
    lib.lrk_branched_matmul.restype = i
    lib.lrk_branched_smem.argtypes = [i, i, i, i, i]
    lib.lrk_branched_smem.restype = ctypes.c_size_t
    lib.lrk_lowrank_matmul_q.argtypes = [i, i, p, p, p, p, p, p, i, i, i,
                                         i, p]
    lib.lrk_lowrank_matmul_q.restype = i
    lib.lrk_branched_matmul_q.argtypes = [i, i, p, p, p, p, p, p, p, p, i,
                                          i, i, i, i, i, p]
    lib.lrk_branched_matmul_q.restype = i
    lib.lrk_decode_attention_q.argtypes = [i, p, p, p, p, p, p, p, i, i, i,
                                           i, i, ctypes.c_float, p]
    lib.lrk_decode_attention_q.restype = i
    lib.lrk_decode_attention_q_fits.argtypes = [i, i, i]
    lib.lrk_decode_attention_q_fits.restype = i
    lib.lrk_error_string.argtypes = [i]
    lib.lrk_error_string.restype = ctypes.c_char_p
    return lib


#: shared memory a CTA may opt into on an H100 (bytes)
SMEM_LIMIT = 232448


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = lib.lrk_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {rc} ({msg})")
