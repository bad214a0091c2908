"""Logical-axis -> mesh-axis resolution (DP / FSDP / TP / EP / SP).

Every parameter carries a tuple of *logical* axis names (built by
``ParamBuilder``); this module resolves them onto the production mesh
``(pod, data, model)`` per the reference's rule table, derived from
``ParallelConfig`` (``repro/parallel/sharding.py``):

    vocab    -> model         (TP on embed/unembed; replicate if indivisible)
    ffn/qkv  -> model         (the Megatron col/row pattern falls out of
                               the in/out logical names on each weight)
    inner    -> model         (SSM d_inner TP)
    experts  -> model         (EP: expert banks shard over chips)
    embed    -> data if FSDP  (param + optimizer-state sharding)
    rank     -> None          (default: factors inherit the dense layer's
                               sharding), data under FSDP
             -> model if ``shard_rank``
    batch    -> (pod, data)   pure DP across pods, DP+FSDP within
    seq      -> model if SP   (activation sequence sharding)

A mesh axis is used at most once per tensor; conflicts resolve by a fixed
priority (EP > vocab > ffn/qkv/inner > heads > rank).  Dims not divisible
by their mesh-axis size fall back to replication, with a note.

Resolution is pure: it reads a mesh's axis names and sizes alone (a
``torch.distributed.device_mesh.DeviceMesh``, an :class:`AbstractMesh`,
or any object whose ``shape`` maps axis names to sizes) and returns the
twin of a ``PartitionSpec``: a tuple with one entry per leading tensor
dim, each a mesh-axis name, a tuple of names or ``None``, trailing
``None``s dropped.  :func:`placements` turns a spec into DTensor
placements on a ``DeviceMesh``.  How the port computes under the
resolved layout is ``parallel/placement.py``'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from repro_torch.configs.base import ParallelConfig
from repro_torch.layers import param as lp
from repro_torch.tree import tree_map

PyTree = Any

# Priority for claiming the `model` axis when several logical axes on one
# tensor map to it (a mesh axis may appear only once per spec).
_MODEL_PRIORITY = {
    lp.EXPERTS: 0, lp.VOCAB: 1, lp.FFN: 2, lp.QKV: 2, lp.INNER: 2,
    lp.HEADS: 3, lp.KV_HEADS: 3, lp.RANK: 4,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without a process group (the twin
    of ``jax.sharding.AbstractMesh``): what resolution reads."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The twin of ``jax.sharding.NamedSharding``: a mesh and a spec."""
    mesh: Any
    spec: tuple


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                               # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` where tensor dim ``i`` is split over that axis, else
    ``Replicate()``."""
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:                                 # torch < 2.4
        from torch.distributed._tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for ax in _axis_names(entry):
            out[names.index(ax)] = Shard(dim)
    return out


def _rules(parallel: ParallelConfig) -> dict[str, Any]:
    """logical axis -> mesh axis (or None) for *parameters*."""
    rules: dict[str, Any] = {
        lp.VOCAB: "model",
        lp.FFN: "model",
        lp.QKV: "model",
        lp.INNER: "model",
        lp.EXPERTS: "model",
        lp.EMBED: "data" if parallel.fsdp else None,
        # RANK: the factor that lost its EMBED/FFN dim must still FSDP-shard
        # (else its f32 optimizer moments replicate over `data`).  Priority
        # rules keep one axis use.
        lp.RANK: "model" if parallel.shard_rank
        else ("data" if parallel.fsdp else None),
        lp.HEADS: "model",
        lp.KV_HEADS: "model",
        lp.LAYERS: None,
        lp.BRANCH: None,
        lp.CONV: None,
        lp.STATE: None,
        lp.HEAD_DIM: None,
        lp.BATCH: None,
        lp.SEQ: None,
        None: None,
    }
    if not parallel.shard_vocab:
        rules[lp.VOCAB] = None
    return rules


def _spec_for(axes: tuple, shape: tuple[int, ...], rules: dict, mesh,
              notes: list[str] | None = None, path: str = "") -> tuple:
    assert len(axes) == len(shape), (axes, shape)
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    # resolve high-priority dims first, then fill in order
    order = sorted(range(len(axes)),
                   key=lambda i: _MODEL_PRIORITY.get(axes[i], 9))
    resolved: dict[int, Any] = {}
    for i in order:
        ax = rules.get(axes[i], None)
        if ax is None:
            resolved[i] = None
            continue
        ax_names = _axis_names(ax)
        if any(a in used for a in ax_names):
            resolved[i] = None
            continue
        size = math.prod(sizes[a] for a in ax_names)
        if shape[i] % size != 0:
            if notes is not None:
                notes.append(f"{path}: dim {i} ({axes[i]}={shape[i]}) "
                             f"not divisible by {ax}={size}; replicated")
            resolved[i] = None
            continue
        used.update(ax_names)
        resolved[i] = ax
    entries = [resolved[i] for i in range(len(axes))]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def make_param_shardings(mesh, params: PyTree, axes: PyTree,
                         parallel: ParallelConfig,
                         notes: list[str] | None = None) -> PyTree:
    """:class:`NamedSharding` tree matching ``params`` (leaves: anything
    with a ``shape``: tensors, ``meta`` tensors).

    Quant- and sparse-aware: a tree rewritten by ``quantize_tree`` or
    ``sparsify_tree`` after the axes were built still resolves — ``k_q``
    leaves inherit ``k``'s logical axes, ``k_scale`` leaves shard on the
    out-dim axis (or replicate), and 2:4-packed ``k_sp`` / ``k_idx``
    leaves keep ``k``'s out-dim sharding with the packed slot/group axes
    replicated — all via ``quant/quantize.py::align_quantized_axes`` per
    dict node.
    """
    from repro_torch.quant.quantize import align_quantized_axes
    rules = _rules(parallel)

    def walk(p: Any, a: Any, path: tuple[str, ...]) -> Any:
        if isinstance(p, dict):
            a2 = align_quantized_axes(p, a) if isinstance(a, dict) else a
            return {k: walk(p[k], a2[k], (*path, k)) for k in p}
        spec = _spec_for(tuple(a), tuple(p.shape), rules, mesh, notes,
                         "/".join(path))
        return NamedSharding(mesh, spec)

    return walk(params, axes, ())


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _data_axes(mesh) -> Any:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else "data"


def _data_size(mesh) -> int:
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in _axis_names(_data_axes(mesh)))


def activation_resolver(mesh, parallel: ParallelConfig) -> Callable:
    """Returns fn(logical_axes, shape) -> NamedSharding | None for
    ``shard_act``."""
    data = _data_axes(mesh)
    data_size = _data_size(mesh)
    model_size = mesh_shape(mesh)["model"]

    def rule(axes: tuple, shape: tuple[int, ...]):
        entries = []
        used = set()
        for ax, dim in zip(axes, shape):
            tgt = None
            if ax == lp.BATCH and "d" not in used and dim % data_size == 0:
                tgt = data
                used.add("d")
            elif ax == lp.SEQ and parallel.seq_shard and "m" not in used \
                    and dim % model_size == 0:
                tgt = "model"
                used.add("m")
            elif ax in (lp.FFN, lp.QKV, lp.HEADS, lp.KV_HEADS, lp.EXPERTS,
                        lp.VOCAB, lp.INNER) \
                    and "m" not in used and dim % model_size == 0:
                tgt = "model"
                used.add("m")
            entries.append(tgt)
        while entries and entries[-1] is None:
            entries.pop()
        if not entries:
            return None
        return NamedSharding(mesh, tuple(entries))

    return rule


def install_activation_rules(mesh, parallel: ParallelConfig) -> None:
    lp.set_activation_resolver(activation_resolver(mesh, parallel))


def clear_activation_rules() -> None:
    lp.set_activation_resolver(None)


# ---------------------------------------------------------------------------
# Inputs / caches
# ---------------------------------------------------------------------------

def batch_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, (_data_axes(mesh),))


def input_shardings(mesh, specs: dict, parallel: ParallelConfig) -> dict:
    """Shard every step input along its leading (batch) dim where
    divisible."""
    data = _data_axes(mesh)
    data_size = _data_size(mesh)
    out = {}
    for name, spec in specs.items():
        if spec.shape and spec.shape[0] % data_size == 0:
            out[name] = NamedSharding(mesh, (data,))
        else:
            out[name] = NamedSharding(mesh, ())
    return out


def cache_shardings(mesh, cache_spec: PyTree, parallel: ParallelConfig,
                    batch: int, seq_len: int | None = None) -> PyTree:
    """KV caches / SSM states (leaves: anything with a ``shape``).

    Attention caches shard **batch over data, cache-seq over model**; when
    the batch is unshardable (B=1 long-context decode) and
    ``decode_seq_shard`` is set, the seq dim takes both axes.  SSM states
    have no seq dim: heads shard over model, batch over data.  The port's
    engine keeps its pool local (``parallel/placement.py``); these are the
    reference's rules, resolved."""
    data = _data_axes(mesh)
    data_size = _data_size(mesh)
    model_size = mesh_shape(mesh)["model"]

    def leaf(spec):
        # Layouts (leading stack dims first):
        #   KV cache      (L.., B, S, KH, hd)
        #   MLA cache     (L.., B, S, lora)
        #   SSM state     (L,  B, nh, hd, N)
        #   conv tail     (L,  B, w-1, d_inner or 2N)
        shape = tuple(spec.shape)
        entries: list[Any] = [None] * len(shape)
        try:
            bi = next(i for i, d in enumerate(shape) if d == batch)
        except StopIteration:
            return NamedSharding(mesh, ())
        has_seq = (seq_len is not None and len(shape) > bi + 1
                   and shape[bi + 1] == seq_len)
        batch_shardable = batch % data_size == 0
        if batch_shardable:
            entries[bi] = data
        if has_seq:
            si = bi + 1
            if not batch_shardable and parallel.decode_seq_shard:
                both = ((*data, "model") if isinstance(data, tuple)
                        else (data, "model"))
                if shape[si] % (data_size * model_size) == 0:
                    entries[si] = both
                elif shape[si] % model_size == 0:
                    entries[si] = "model"
            elif shape[si] % model_size == 0:
                entries[si] = "model"
        else:
            # SSM state: shard the heads dim (first dim after batch
            # divisible by model) to match d_inner TP
            for i in range(bi + 1, len(shape)):
                if shape[i] % model_size == 0 and shape[i] >= model_size:
                    entries[i] = "model"
                    break
        while entries and entries[-1] is None:
            entries.pop()
        return NamedSharding(mesh, tuple(entries))

    return tree_map(leaf, cache_spec)
