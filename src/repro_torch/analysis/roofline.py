"""Roofline analysis of one call of a step (the dry run's perf report).

The reference parses XLA's optimized, post-SPMD HLO
(``src/repro/analysis/roofline.py``).  The port has no HLO: a
:class:`StepCounter` (a ``TorchDispatchMode``) watches one call of a step
and counts, per device, at the port's op boundaries:

* **FLOPs** -- torch's FLOP formulas (``torch.utils.flop_counter``: mm,
  bmm, addmm, baddbmm, convolution, the fused attentions), which give the
  reference's ``_dot_flops`` / ``_conv_flops``.  A Python loop over the
  layers runs its ops once a trip, so no trip count is read.
* **HBM traffic** -- the reference's no-reuse convention at op
  boundaries: every non-view aten op is charged its output plus its
  inputs (inputs of 128 bytes or less skipped, as the reference skips
  them); views and metadata ops are free; an in-place write into part of
  a buffer (``index_put_``, ``index_copy_``, ``scatter_``, ``copy_``
  into a slice) is charged the slice, not the buffer (the reference's
  dynamic-update-slice rule).
* **Collective bytes** -- per ``c10d`` op, the payload times the ring
  factor of its process group's size N (all-reduce 2(N-1)/N, all-gather
  / reduce-scatter / all-to-all (N-1)/N, send / recv 1), the reference's
  ``_collective_bytes``.
* **Kernels** -- every entry point of :mod:`repro_torch.kernels.ops` is
  one fused op: it is charged :func:`kernel_cost` once (its unique bytes:
  x, the factors and the scales read once, y written once), and counting
  is suspended while it runs, so neither the plain version's
  intermediates (a CPU tensor) nor anything around the ctypes launch (a
  CUDA tensor) is charged again.  The card and the CPU so count a step
  alike.  Under autograd only the forward runs inside the entry point;
  the backward's explicit products are aten ops, counted as such.

The three roofline terms then follow from :mod:`repro_torch.analysis.
hw_specs`, with the reference's formulas::

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = HBM_bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / link_bw
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.hw_specs import DEFAULT, HardwareSpec

#: ops that allocate, alias or read metadata only: no traffic
#: (``_unsafe_view`` is ``reshape``'s view of a fresh tensor, though its
#: schema does not mark it a view)
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "_unsafe_view",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "set_", "resize_", "record_stream",
    "is_same_size", "_has_compatible_shallow_copy_type"))

#: in-place writes into part of their first argument: charged the slice
#: they write (the written and the read update), never the whole buffer
_SLICE_WRITES = frozenset(("index_put_", "_index_put_impl_", "index_copy_",
                           "scatter_", "index_add_", "copy_",
                           "index_fill_", "masked_scatter_"))

#: ``c10d`` collective op -> the reference's kind
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(obj: Any) -> list[torch.Tensor]:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------------------
# Kernel costs (one fused op per entry point of kernels/ops.py)
# ---------------------------------------------------------------------------

#: chain entry point -> indices of its weight factors among the arguments
#: (x first; the scales and the 2:4 index rows are read, not multiplied)
CHAIN_FACTORS = {
    "lowrank_matmul": (1, 2), "branched_matmul": (1, 2, 3),
    "lowrank_matmul_q": (1, 3), "branched_matmul_q": (1, 3, 5),
    "lowrank_matmul_qa": (1, 3), "branched_matmul_qa": (1, 3, 5),
    "lowrank_matmul_sq": (1, 4), "branched_matmul_sq": (1, 4, 6),
}
ATTENTIONS = ("decode_attention_q", "decode_attention_paged",
              "decode_attention_paged_q", "decode_attention_latent_q")
KERNELS = tuple(CHAIN_FACTORS) + ATTENTIONS


def kernel_cost(name: str, shapes: Sequence[Sequence[int]],
                dtypes: Sequence[Any], *, live: int | None = None,
                walked: int | None = None) -> tuple[int, int]:
    """``(flops, bytes)`` of one call of the kernel of entry point
    ``name`` on arguments of ``shapes`` / ``dtypes`` (torch dtypes), in
    the entry point's argument order.

    A chain (x (..., C) and its factors) moves x, every factor and scale
    and y (x's dtype) once, and does 2 M x (the values of its weight
    factors) FLOPs: 2 M (C R + R S) for a low-rank pair, 2 M N (C r1 + r1
    r2 + r2 S) for a branched one, the kept half of a 2:4 pack.

    A decode attention reads q and writes the output once, reads the
    scale rows and one int32 ``cache_pos`` a slot, and the K / V of the
    positions its slots reach: ``live`` of them (default every position
    of every slot; ``chip_smoke.py`` and :class:`StepCounter` pass the
    count that the positions of the run need: a live slot's positions up
    to its ``cache_pos``, an idle slot's whole run).  A paged pool reads
    ``walked`` distinct blocks (K, V and their scale rows) and ``live``
    table entries (int32); its defaults are every slot's whole table and
    ``min(live, blocks in the pool)``.  FLOPs are 4 H D a position (H D
    a query row's width: q K^T and p V) and, for the latent attention,
    2 H (2 L + R)."""
    shapes = [tuple(int(d) for d in s) for s in shapes]
    isz = [d.itemsize for d in dtypes]
    if name in CHAIN_FACTORS:
        x = shapes[0]
        m, c = math.prod(x[:-1]), x[-1]
        s = shapes[CHAIN_FACTORS[name][-1]][-1]
        weights = sum(math.prod(shapes[i]) for i in CHAIN_FACTORS[name])
        factors = sum(math.prod(sh) * b for sh, b in zip(shapes[1:], isz[1:]))
        return 2 * m * weights, isz[0] * m * (c + s) + factors
    q = shapes[0]
    b = q[0]
    width = math.prod(q) // b                  # H D of one query row
    if name == "decode_attention_q":
        _, kq, ks, vq, vs, _ = shapes
        _, s, kh, d = kq
        live = b * s if live is None else live
        nbytes = (live * kh * d * (isz[1] + isz[3])
                  + math.prod(ks) * isz[2] + math.prod(vs) * isz[4]
                  + 2 * math.prod(q) * isz[0] + 4 * b)
        return 4 * width * live, nbytes
    if name in ("decode_attention_paged", "decode_attention_paged_q"):
        quant = name.endswith("_q")
        k, tables = shapes[1], shapes[-2]
        nb1, bs, kh, d = k
        vi = 3 if quant else 2
        block = bs * kh * d * (isz[1] + isz[vi])
        if quant:
            block += (math.prod(shapes[2]) * isz[2]
                      + math.prod(shapes[4]) * isz[4]) // nb1
        live = b * tables[1] if live is None else live
        walked = min(live, nb1) if walked is None else walked
        nbytes = (walked * block + 4 * live + 4 * b
                  + 2 * math.prod(q) * isz[0])
        return 4 * width * bs * live, nbytes
    if name == "decode_attention_latent_q":
        _, qr, ckv, cks, kr, krs, _ = shapes
        _, s, lora = ckv
        rope = kr[-1]
        h = math.prod(q) // (b * lora)
        live = b * s if live is None else live
        nbytes = ((2 * math.prod(q) + math.prod(qr)) * isz[0]
                  + live * (lora * isz[2] + rope * isz[4])
                  + math.prod(cks) * isz[3] + math.prod(krs) * isz[5]
                  + 4 * b)
        return 2 * h * (2 * lora + rope) * live, nbytes
    raise KeyError(f"no kernel cost for {name!r}")


def _is_real(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type != "meta" and not is_fake(t)


def attention_reach(name: str, args: Sequence[torch.Tensor]
                    ) -> dict[str, int]:
    """``live`` (and ``walked``) of :func:`kernel_cost` that this call's
    positions need, read from its ``cache_pos`` (and block tables); empty
    where they are not real tensors (fake, meta), whose cost is then the
    shapes' most."""
    pos = args[-1]
    if not _is_real(pos):
        return {}
    cps = pos.reshape(-1).tolist()
    if name in ("decode_attention_paged", "decode_attention_paged_q"):
        tables = args[-2]
        bs, nblk = args[1].shape[1], tables.shape[1]
        walks = [nblk if cp < 0 else min(nblk, cp // bs + 1) for cp in cps]
        rows = tables.tolist()
        seen = {blk for row, w in zip(rows, walks) for blk in row[:w]}
        return {"live": sum(walks), "walked": len(seen)}
    s = args[2].shape[1] if name == "decode_attention_latent_q" \
        else args[1].shape[1]
    return {"live": sum(s if cp < 0 else min(s, cp + 1) for cp in cps)}


def kernel_cost_of(name: str, args: Sequence[torch.Tensor]
                   ) -> tuple[int, int]:
    """:func:`kernel_cost` of a call of entry point ``name`` on the
    tensors ``args`` (in its argument order)."""
    reach = attention_reach(name, args) if name in ATTENTIONS else {}
    return kernel_cost(name, [a.shape for a in args],
                       [a.dtype for a in args], **reach)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCosts:
    """Per-device costs of one call of a step (the reference's
    ``HloCosts`` without ``while_trips``: no loop is traced)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_detail: dict = dataclasses.field(default_factory=dict)
    #: "<kind> N=<group size>" -> bytes (which mesh axis moved them)
    collective_groups: dict = dataclasses.field(default_factory=dict)
    #: entry point -> (launches, FLOPs, bytes) charged as kernels
    kernel_detail: dict = dataclasses.field(default_factory=dict)


def _group_size(args: Sequence[Any]) -> int:
    """The size of the process group a ``c10d`` op's ``args`` carry
    (boxed), 1 if none."""
    import torch.distributed as dist
    for a in tree_flatten(args)[0]:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name() \
                .endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    return 1


def collective_bytes(kind: str, args: Sequence[Any], n: int) -> float:
    """On-wire bytes a device moves for one collective of ``kind`` over
    ``n`` ranks (ring algorithms, the reference's ``_collective_bytes``;
    N below 2 counts as 2, as there)."""
    n = max(2, n)
    ring = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * ring * sum(_nbytes(t) for t in _tensors(args[0]))
    if kind == "all-gather":
        return ring * sum(_nbytes(t) for t in _tensors(args[0]))
    if kind == "reduce-scatter":
        return ring * sum(_nbytes(t) for t in _tensors(args[1]))
    if kind == "all-to-all":
        return ring * sum(_nbytes(t) for t in _tensors(args[0]))
    return float(sum(_nbytes(t) for t in _tensors(args)))   # send / recv


class StepCounter(TorchDispatchMode):
    """Count one call of a step: ``with StepCounter() as c: step(...)``,
    then ``c.costs`` (:class:`StepCosts`, per device: the ops this
    process runs).  Under ``FakeTensorMode`` enter it inside the fake
    mode, so that it sees the ops first.  While it is active, the entry
    points of :mod:`repro_torch.kernels.ops` charge their kernel's cost
    through :meth:`kernel`."""

    def __init__(self):
        super().__init__()
        self.costs = StepCosts()
        self._suspended = 0         # depth of entry points running
        self._prev = None

    def __enter__(self):
        from repro_torch.kernels import ops
        self._prev = ops.set_counter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        try:
            return super().__exit__(*exc)
        finally:
            ops.set_counter(self._prev)

    # -- kernels -------------------------------------------------------------

    @contextlib.contextmanager
    def kernel(self, name: str, args: Sequence[torch.Tensor]):
        """The block of one call of entry point ``name`` on ``args``:
        no aten op inside it counts, and on success the call is charged
        :func:`kernel_cost_of` once (an entry point inside another is
        part of the outer one)."""
        outer = self._suspended
        self._suspended += 1
        try:
            yield
            if not outer:
                flops, nbytes = kernel_cost_of(name, args)
                c = self.costs
                c.flops += flops
                c.hbm_bytes += nbytes
                n, f, b = c.kernel_detail.get(name, (0, 0, 0))
                c.kernel_detail[name] = (n + 1, f + flops, b + nbytes)
        finally:
            self._suspended -= 1

    # -- aten ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._suspended and func is not torch.ops.prim.device.default \
                and func._overloadpacket not in flop_registry:
            # a composite op (reached as itself under inference mode):
            # count the ops it is made of, as outside inference mode
            TorchDispatchMode.__enter__(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._suspended:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.costs
        packet = func._overloadpacket
        ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
        name = func._schema.name.split("::")[-1]
        if ns == "c10d":
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                n = _group_size(args)
                b = collective_bytes(kind, args, n)
                c.collective_bytes += b
                c.collective_detail[kind] = \
                    c.collective_detail.get(kind, 0.0) + b
                key = f"{kind} N={n}"
                c.collective_groups[key] = \
                    c.collective_groups.get(key, 0.0) + b
            else:
                return
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if func.is_view or name in _FREE or not outs:
            return                      # views, metadata, scalar reads
        if name in _SLICE_WRITES:
            upd = _tensors(args[1:]) + _tensors(kwargs)
            # the write: the values written (copy_'s destination is the
            # slice itself); the reads: the update operands
            written = _nbytes(args[0]) if name == "copy_" else \
                max((_nbytes(t) for t in upd), default=0)
            c.hbm_bytes += written + sum(_nbytes(t) for t in upd
                                         if _nbytes(t) > 128)
            return
        c.hbm_bytes += sum(_nbytes(t) for t in outs)
        c.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))
                           if _nbytes(t) > 128)


# ---------------------------------------------------------------------------
# Roofline report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float
    bottleneck: str
    useful_ratio: float
    detail: dict

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """model-useful compute time / bound step time (the score)."""
        if self.step_s <= 0:
            return 0.0
        return min(1.0, (self.model_flops and
                         self.model_flops / self.flops or 0.0)
                   * self.compute_s / self.step_s)


def roofline(costs: StepCosts, *, n_devices: int, model_flops_global: float,
             spec: HardwareSpec = DEFAULT) -> Roofline:
    """``costs`` are per-device; model_flops are global."""
    compute = costs.flops / spec.peak_flops_bf16
    memory = costs.hbm_bytes / spec.hbm_bandwidth
    coll = costs.collective_bytes / spec.ici_link_bandwidth
    model_per_dev = model_flops_global / n_devices
    terms = {"compute": compute, "memory": memory, "collective": coll}
    bottleneck = max(terms, key=terms.get)
    useful = model_per_dev / costs.flops if costs.flops else 0.0
    return Roofline(compute, memory, coll, costs.flops, costs.hbm_bytes,
                    costs.collective_bytes, model_per_dev, bottleneck,
                    useful, dict(costs.collective_detail))
