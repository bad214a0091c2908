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
from typing import Callable

import torch

from repro_torch.analysis.hw_specs import H100

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("lowrank_matmul.cu", "branched_matmul.cu", "lowrank_matmul_q.cu",
           "branched_matmul_q.cu", "decode_attention_q.cu",
           "lowrank_matmul_qa.cu", "branched_matmul_qa.cu",
           "decode_attention_paged.cu", "decode_attention_latent_q.cu",
           "lowrank_matmul_sq.cu", "branched_matmul_sq.cu",
           "chain_wgmma.cu", "chain_f32.cu", "chain_dequant.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: shared memory a CTA may opt into on an H100 (bytes)
SMEM_LIMIT = int(H100.vmem_bytes)
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         f"-DLRK_SMEM_LIMIT={SMEM_LIMIT}"]
LIB_NAME = "libreprotorch_kernels.so"
#: activation dtypes the kernels take, with their code in the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    lib.lrk_lowrank_matmul.argtypes = [i, i, p, p, p, p, i, i, i, i, p]
    lib.lrk_lowrank_matmul.restype = i
    lib.lrk_lowrank_smem.argtypes = [i, i, i]
    lib.lrk_lowrank_smem.restype = ctypes.c_size_t
    lib.lrk_branched_matmul.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i,
                                        i, p]
    lib.lrk_branched_matmul.restype = i
    lib.lrk_branched_smem.argtypes = [i, i, i, i, i]
    lib.lrk_branched_smem.restype = ctypes.c_size_t
    lib.lrk_branched_matmul_mma.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                            i, i, i, i, i, i, p, p]
    lib.lrk_branched_matmul_mma.restype = i
    lib.lrk_branched_mma_smem.argtypes = []
    lib.lrk_branched_mma_smem.restype = ctypes.c_size_t
    lib.lrk_branched_mma_grid.argtypes = [i]
    lib.lrk_branched_mma_grid.restype = i
    lib.lrk_branched_matmul_q_mma.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                              p, p, i, i, i, i, i, i, i, i,
                                              i, p, p]
    lib.lrk_branched_matmul_q_mma.restype = i
    lib.lrk_branched_matmul_sq_mma.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                               p, p, p, p, i, i, i, i, i, i,
                                               i, i, i, p, p]
    lib.lrk_branched_matmul_sq_mma.restype = i
    for kind in ("q", "sq"):
        getattr(lib, f"lrk_branched_{kind}_mma_smem").argtypes = []
        getattr(lib, f"lrk_branched_{kind}_mma_smem").restype = \
            ctypes.c_size_t
        getattr(lib, f"lrk_branched_{kind}_mma_grid").argtypes = [i, i]
        getattr(lib, f"lrk_branched_{kind}_mma_grid").restype = i
    lib.lrk_lowrank_matmul_q.argtypes = [i, i, i, p, p, p, p, p, p, i, i,
                                         i, i, p]
    lib.lrk_lowrank_matmul_q.restype = i
    lib.lrk_branched_matmul_q.argtypes = [i, i, i, p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, i, p]
    lib.lrk_branched_matmul_q.restype = i
    lib.lrk_lowrank_matmul_sq.argtypes = [i, i, i, p, p, p, p, p, p, p, p,
                                          i, i, i, i, p]
    lib.lrk_lowrank_matmul_sq.restype = i
    lib.lrk_lowrank_matmul_sq_mma.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                              p, i, i, i, i, i, i, i, p, p]
    lib.lrk_lowrank_matmul_sq_mma.restype = i
    lib.lrk_lowrank_matmul_mma.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, i, p, p]
    lib.lrk_lowrank_matmul_mma.restype = i
    lib.lrk_lowrank_mma_smem.argtypes = []
    lib.lrk_lowrank_mma_smem.restype = ctypes.c_size_t
    lib.lrk_lowrank_mma_grid.argtypes = [i]
    lib.lrk_lowrank_mma_grid.restype = i
    lib.lrk_lowrank_matmul_q_mma.argtypes = [i, p, p, p, p, p, p, p, p, i, i,
                                             i, i, i, i, i, p, p]
    lib.lrk_lowrank_matmul_q_mma.restype = i
    lib.lrk_lowrank_q_mma_smem.argtypes = []
    lib.lrk_lowrank_q_mma_smem.restype = ctypes.c_size_t
    lib.lrk_lowrank_q_mma_grid.argtypes = [i, i]
    lib.lrk_lowrank_q_mma_grid.restype = i
    lib.lrk_lowrank_sq_mma_smem.argtypes = []
    lib.lrk_lowrank_sq_mma_smem.restype = ctypes.c_size_t
    lib.lrk_lowrank_sq_mma_grid.argtypes = [i, i]
    lib.lrk_lowrank_sq_mma_grid.restype = i
    lib.lrk_branched_matmul_sq.argtypes = [i, i, i, p, p, p, p, p, p, p, p,
                                           p, p, i, i, i, i, i, i, p]
    lib.lrk_branched_matmul_sq.restype = i
    lib.lrk_decode_attention_q.argtypes = [i, p, p, p, p, p, p, p, p, p, i,
                                           i, i, i, i, i, i, ctypes.c_float,
                                           p]
    lib.lrk_decode_attention_q.restype = i
    lib.lrk_decode_attention_q_prev.argtypes = [i, p, p, p, p, p, p, p, i,
                                                i, i, i, i, ctypes.c_float,
                                                p]
    lib.lrk_decode_attention_q_prev.restype = i
    lib.lrk_decode_attention_q_fits.argtypes = [i, i, i]
    lib.lrk_decode_attention_q_fits.restype = i
    lib.lrk_lowrank_matmul_qa.argtypes = [i, i, p, p, p, p, p, p, i, i, i,
                                          i, p]
    lib.lrk_lowrank_matmul_qa.restype = i
    lib.lrk_lowrank_qa_smem.argtypes = [i, i]
    lib.lrk_lowrank_qa_smem.restype = ctypes.c_size_t
    lib.lrk_lowrank_matmul_qa_mma.argtypes = [i, *[p] * 11, *[i] * 7, p, p]
    lib.lrk_lowrank_matmul_qa_mma.restype = i
    lib.lrk_lowrank_qa_mma_smem.argtypes = []
    lib.lrk_lowrank_qa_mma_smem.restype = ctypes.c_size_t
    lib.lrk_lowrank_qa_mma_grid.argtypes = [i, i]
    lib.lrk_lowrank_qa_mma_grid.restype = i
    lib.lrk_branched_matmul_qa.argtypes = [i, i, p, p, p, p, p, p, p, p, i,
                                           i, i, i, i, i, p]
    lib.lrk_branched_matmul_qa.restype = i
    lib.lrk_branched_qa_smem.argtypes = [i, i, i, i]
    lib.lrk_branched_qa_smem.restype = ctypes.c_size_t
    lib.lrk_branched_matmul_qa_mma.argtypes = [i, *[p] * 15, *[i] * 9, p, p]
    lib.lrk_branched_matmul_qa_mma.restype = i
    lib.lrk_branched_qa_mma_smem.argtypes = []
    lib.lrk_branched_qa_mma_smem.restype = ctypes.c_size_t
    lib.lrk_branched_qa_mma_grid.argtypes = [i, i]
    lib.lrk_branched_qa_mma_grid.restype = i
    lib.lrk_decode_attention_paged.argtypes = [i, p, p, p, p, p, p, p, p, i,
                                               i, i, i, i, i, i, i,
                                               ctypes.c_float, p]
    lib.lrk_decode_attention_paged.restype = i
    lib.lrk_decode_attention_paged_prev.argtypes = [
        i, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    lib.lrk_decode_attention_paged_prev.restype = i
    lib.lrk_decode_attention_paged_q.argtypes = [i, p, p, p, p, p, p, p, p,
                                                 p, p, i, i, i, i, i, i, i,
                                                 i, ctypes.c_float, p]
    lib.lrk_decode_attention_paged_q.restype = i
    lib.lrk_decode_attention_paged_q_prev.argtypes = [
        i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    lib.lrk_decode_attention_paged_q_prev.restype = i
    lib.lrk_decode_attention_paged_fits.argtypes = [i, i, i, i]
    lib.lrk_decode_attention_paged_fits.restype = i
    lib.lrk_decode_attention_paged_split_fits.argtypes = [i, i, i, i, i, i]
    lib.lrk_decode_attention_paged_split_fits.restype = i
    lib.lrk_decode_attention_paged_split_smem.argtypes = [i, i, i, i, i,
                                                          i]
    lib.lrk_decode_attention_paged_split_smem.restype = ctypes.c_size_t
    lib.lrk_decode_attention_latent_q.argtypes = [i, p, p, p, p, p, p, p, p,
                                                  p, p, i, i, i, i, i, i, i,
                                                  i, i, ctypes.c_float, p]
    lib.lrk_decode_attention_latent_q.restype = i
    lib.lrk_decode_attention_latent_q_smem.argtypes = [i, i, i, i]
    lib.lrk_decode_attention_latent_q_smem.restype = ctypes.c_size_t
    lib.lrk_decode_attention_latent_q_prev.argtypes = [
        i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    lib.lrk_decode_attention_latent_q_prev.restype = i
    lib.lrk_decode_attention_latent_q_prev_smem.argtypes = [i, i, i]
    lib.lrk_decode_attention_latent_q_prev_smem.restype = ctypes.c_size_t
    lib.lrk_chain_wgmma.argtypes = [i, p, p, i, p, i, p]
    lib.lrk_chain_wgmma.restype = i
    lib.lrk_chain_f32.argtypes = [i, p, p, p, i, p]
    lib.lrk_chain_f32.restype = i
    lib.lrk_dequant_rows.argtypes = [i, p, p, i, i, p]
    lib.lrk_dequant_rows.restype = i
    lib.lrk_error_string.argtypes = [i]
    lib.lrk_error_string.restype = ctypes.c_char_p
    return lib


#: the row block heights the f32 cluster chain kernels are built for,
#: tallest first (``lrk_common.cuh::known_bm``): f32 B3, B4, B11 and B12,
#: and the cluster yardsticks of B1 / B2; bf16's cluster kernels and the
#: activation-quantized ones stop at 8 rows
F32_HEIGHTS = (32, 8, 4)
HEIGHTS = (32, 8)


def chain_heights(dtype: torch.dtype) -> tuple[int, ...]:
    """The row block heights a plain, quantized or 2:4 chain kernel takes
    for activations of ``dtype``."""
    return F32_HEIGHTS if dtype == torch.float32 else HEIGHTS


def chain_bm(m: int, smem_at: Callable[[int], int],
             heights: tuple[int, ...] = HEIGHTS) -> tuple[int, int]:
    """The row block height a chain kernel (the lowrank and branched
    families) launches with for ``m`` activation rows, and the shared
    memory that launch needs: 32 rows where ``m > 8`` and the 32-row
    intermediates fit, else the tallest of the lower ``heights`` that
    fits, else the lowest.  ``smem_at(bm)`` gives the bytes at a block
    height (the library's ``lrk_*_smem``).  :func:`chain_fit` raises
    where even the lowest does not fit."""
    tried = [h for h in heights if h <= 8 or m > 8]
    for bm in tried:
        smem = int(smem_at(bm))
        if smem <= SMEM_LIMIT:
            return bm, smem
    return tried[-1], smem


def chain_fit(m: int, smem_at: Callable[[int], int],
              heights: tuple[int, ...], what: str) -> tuple[int, int]:
    """:func:`chain_bm`, raising ``ValueError`` naming ``what`` (the
    kernel and its ranks) where even the lowest block does not fit."""
    bm, smem = chain_bm(m, smem_at, heights)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what} needs {smem} B of shared memory at {bm} "
                         f"rows (limit {SMEM_LIMIT})")
    return bm, smem


#: zeroed int32 tickets of the split attention kernels, per (device,
#: stream): the kernel leaves them zero again, so one buffer serves every
#: launch on that stream
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def tickets(device, n: int):
    """At least ``n`` int32 tickets, all zero, for a launch on ``device``'s
    current stream.  The split kernels count the finished CTAs of each
    fold group on them and the last CTA resets its ticket, so the buffer
    is zeroed once, when it is made (or grown), and never again."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = lib.lrk_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {rc} ({msg})")
