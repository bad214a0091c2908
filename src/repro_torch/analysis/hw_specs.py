"""Hardware constants of the NVIDIA H100 SXM.

Single source of truth for the constants the port reads: Algorithm 1's
cost model (:mod:`repro_torch.core.cost_model`) reads the peak rates,
the memory rate and the column tile, and its measured timer the L2
size; the kernel build (``kernels/build.py`` ``SMEM_LIMIT``, passed to
every CUDA source as ``LRK_SMEM_LIMIT``) reads the shared-memory limit;
``chip_smoke.py``'s roofline bounds and its L2 flush read the rates and
the L2 size; the roofline (:mod:`repro_torch.analysis.roofline`,
the dry run's report) reads ``peak_flops_bf16``, ``hbm_bandwidth``,
``ici_link_bandwidth`` and ``hbm_bytes`` (whether a cell fits).  The
numbers are NVIDIA's data sheet constants (dense rates, SXM part, 700
W), not measurements.

``HardwareSpec`` keeps the reference's field names, which were chosen
for a TPU, so that the parity tests can build the reference's TPU spec
in the port; on the H100 they mean:

* ``mxu_dim`` -- the column tile of the port's split-phase kernels
  (``kernels/branched_matmul.py`` ``BN``): a rank pads to it;
* ``sublanes`` -- the copy granule of their staging, one 16-byte
  ``cp.async`` chunk of eight bf16 (``csrc/mma_chain.cuh``
  ``copy_chunk``);
* ``vmem_bytes`` -- the shared memory one block may opt into;
* ``ici_link_bandwidth`` -- one NVLink 4 link (900 GB/s over 18 links).
  The roofline's collective term divides a device's ring bytes by it:
  the reference's per-link convention, not a model of an H100
  cluster's NVLink and InfiniBand topology.

``sublanes`` and :func:`sublane_padded` are the reference's and nothing
in the port reads them yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per card, bf16 on the tensor cores
    hbm_bandwidth: float        # B/s per card
    hbm_bytes: float            # HBM capacity per card
    ici_link_bandwidth: float   # B/s per chip-to-chip link
    mxu_dim: int                # matmul column tile
    sublanes: int               # copy granule (elements)
    vmem_bytes: float           # on-chip memory one block may use
    int8_mxu_mult: float = 2.0  # int8 x int8 issue rate vs bf16
    peak_flops_f32: float = 0.0  # FLOP/s outside the tensor cores (the
                                 # bounds of f32 kernels; the cost model
                                 # never reads it)
    l2_bytes: int = 0           # L2 cache per card (the measured timer
                                # and chip_smoke's flush write twice it)
    peak_flops_tf32: float = 0.0  # FLOP/s of TF32 on the tensor cores
                                  # (a third of it bounds the f32 chains'
                                  # split-TF32 form; the cost model never
                                  # reads it)

    def peak_flops(self, operand_bytes: int = 2) -> float:
        """Matmul FLOP/s at the *widest* operand width feeding the dot:
        int8 x int8 (both operands 1 byte) issues at ``int8_mxu_mult``
        times the bf16 rate; anything wider -- int8 weights dequantized
        against full-width activations included -- at the base rate (the
        reference's rule, kept as it is)."""
        if operand_bytes <= 1:
            return self.peak_flops_bf16 * self.int8_mxu_mult
        return self.peak_flops_bf16


H100 = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    ici_link_bandwidth=50e9,
    mxu_dim=128,
    sublanes=8,
    vmem_bytes=232448,          # cudaDevAttrMaxSharedMemoryPerBlockOptin
    int8_mxu_mult=1979 / 989,   # the data sheet's 1,979 TOP/s int8
    peak_flops_f32=67e12,
    l2_bytes=50 * 1024 * 1024,
    peak_flops_tf32=495e12,
)

DEFAULT = H100


def mxu_padded(dim: int, spec: HardwareSpec = DEFAULT) -> int:
    """``dim`` zero-padded up to a multiple of the column tile."""
    t = spec.mxu_dim
    return ((dim + t - 1) // t) * t


def sublane_padded(dim: int, spec: HardwareSpec = DEFAULT) -> int:
    """``dim`` padded up to a multiple of the copy granule."""
    t = spec.sublanes
    return ((dim + t - 1) // t) * t
