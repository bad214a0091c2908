"""Computing on a mesh: each rank stores its shards, and every block
gathers its leaves to whole tensors where it uses them.

The reference partitions the products themselves under GSPMD (the
Megatron column / row pattern, the M x R partial-sum all-reduce of a
low-rank pair).  The port keeps the reference's *storage* layout
(:func:`repro_torch.parallel.sharding.make_param_shardings`) and computes
FSDP-style instead (ROADMAP C):

* :func:`place` turns a whole tree into :class:`Placed` leaves: this
  rank's shard of each leaf, its spec and the whole leaf's shape.
* The model gathers at use: ``LMModel``'s entry points gather every leaf
  outside the layer stacks, and each block function its own layer's
  leaves (:func:`gather_tree`), so a whole stack is never gathered at
  once.  The gather all-gathers over the mesh axes the leaf is split on;
  the kernels then run unchanged on whole local tensors.
* Activations stay local and split over the batch axes ``(pod, data)``
  (:func:`local_rows`).  A gather's backward averages the gradient over
  ``data`` (its ranks saw other rows) and keeps this rank's shard of it:
  a reduce-scatter where the leaf is split over ``data``, a slice where
  it is split over ``model``, whose ranks saw the same rows.  The ``pod``
  sync is the train step's (EF-PowerSGD or a plain mean).

Every rank walks a tree in the same (dict) order, so the collectives of
a step match across ranks; a leaf that needs no gradient (a frozen
factor) launches no collective on any rank.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import NamedSharding, mesh_shape
from repro_torch.tree import leaves, tree_map

PyTree = Any

#: the mesh axes the batch rows are split over, outermost first
BATCH_AXES = ("pod", "data")


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Placed:
    """One rank's shard of a placed leaf: ``local`` the shard, ``spec``
    the sharding's spec padded to one entry per dim, ``shape`` the whole
    leaf's shape, ``mesh`` the ``DeviceMesh``.  Indexing and ``unbind``
    along the (never split) leading layer axis give the layer's
    :class:`Placed`."""
    __slots__ = ("local", "spec", "shape", "mesh")

    def __init__(self, local: torch.Tensor, spec: tuple,
                 shape: tuple[int, ...], mesh):
        self.local, self.spec, self.mesh = local, spec, mesh
        self.shape = torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def _layer(self, t: torch.Tensor) -> "Placed":
        if self.spec[0] is not None:
            raise ValueError(f"dim 0 is split over {self.spec[0]}: not a "
                             "layer axis")
        return Placed(t, self.spec[1:], tuple(self.shape[1:]), self.mesh)

    def __getitem__(self, i: int) -> "Placed":
        return self._layer(self.local[i])

    def unbind(self, dim: int = 0) -> list["Placed"]:
        assert dim == 0, dim
        return [self._layer(t) for t in self.local.unbind(0)]


def _axes(mesh) -> dict[str, tuple[int, int, Any]]:
    """axis -> (size, this rank's index, group) of a ``DeviceMesh``, read
    once and kept on the mesh (the block functions ask at every call)."""
    info = getattr(mesh, "_placement_axes", None)
    if info is None:
        info = {ax: (n, mesh.get_local_rank(ax), mesh.get_group(ax))
                for ax, n in mesh_shape(mesh).items()}
        mesh._placement_axes = info
    return info


def _chunk(spec: tuple, mesh, dim: int, length: int) -> tuple[int, int]:
    """(start, size) of this rank's chunk of dim ``dim`` (whole length
    ``length``) under ``spec``: the chunks go row-major over the dim's
    mesh axes."""
    axes = _axes(mesh)
    idx, n = 0, 1
    for ax in _names(spec[dim]):
        idx = idx * axes[ax][0] + axes[ax][1]
        n *= axes[ax][0]
    return idx * (length // n), length // n


def shard_of(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of a whole tensor, contiguous: a copy where the
    spec splits it over more than one rank, else ``full`` itself."""
    t = full
    for dim in range(len(spec)):
        if spec[dim] is not None:
            start, size = _chunk(spec, mesh, dim, full.shape[dim])
            if size != full.shape[dim]:
                t = t.narrow(dim, start, size)
    if t is full:
        return full.contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Concatenate ``t`` of every rank of ``group`` (``n`` ranks, in
    their group order) along ``dim``; moved as bytes, so any dtype.  A
    one-rank group needs no collective."""
    if n == 1:
        return t.contiguous()
    x = t.movedim(dim, 0).contiguous()
    flat = x.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    out = torch.cat(parts).view(x.dtype).reshape(n * x.shape[0],
                                                 *x.shape[1:])
    return out.movedim(0, dim).contiguous()     # the kernels take
                                                # contiguous operands


def _gather_value(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    axes = _axes(mesh)
    t = local
    for dim, entry in enumerate(spec):
        for ax in reversed(_names(entry)):
            n, _, group = axes[ax]
            t = _all_gather(t, dim, group, n)
    return t


def mean_over(t: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``t`` averaged over the ranks of the mesh ``axes`` (in f32, back
    in ``t``'s dtype; axes of one rank need no collective)."""
    info = _axes(mesh)
    axes = [ax for ax in axes if ax in info and info[ax][0] > 1]
    if not axes:
        return t
    out = t.to(torch.float32).clone()
    for ax in axes:
        dist.all_reduce(out, group=info[ax][2])
        out /= info[ax][0]
    return out.to(t.dtype)


class _Gather(torch.autograd.Function):
    """Forward: the whole leaf from every rank's shard.  Backward: the
    gradient averaged over ``data``, then this rank's shard of it."""

    @staticmethod
    def forward(ctx, local, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        with torch.no_grad():
            return _gather_value(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        g = mean_over(g, ctx.mesh, ("data",))
        return shard_of(g, ctx.spec, ctx.mesh), None, None


def gather(p: Placed) -> torch.Tensor:
    """The whole leaf of ``p``, differentiable in ``p.local``."""
    if torch.is_grad_enabled() and p.local.requires_grad:
        return _Gather.apply(p.local, p.spec, p.mesh)
    with torch.no_grad():
        return _gather_value(p.local, p.spec, p.mesh)


def _first_leaf(tree: PyTree) -> Any:
    while isinstance(tree, dict) and tree:
        tree = next(iter(tree.values()))
    return tree


def is_placed(tree: PyTree) -> bool:
    """Does ``tree`` hold :class:`Placed` leaves (a placed tree holds
    nothing else)?"""
    return isinstance(_first_leaf(tree), Placed)


def gather_tree(tree: PyTree) -> PyTree:
    """Every :class:`Placed` leaf of ``tree`` gathered (:func:`gather`);
    a tree that is not placed comes back as it is."""
    if not is_placed(tree):
        return tree
    return tree_map(lambda p: gather(p) if isinstance(p, Placed) else p,
                    tree)


def gather_outside(params: PyTree, stacked: tuple[str, ...]) -> PyTree:
    """:func:`gather_tree` of every top-level subtree of ``params`` but
    the layer stacks ``stacked``, which their block functions gather a
    layer at a time."""
    if not is_placed(params):
        return params
    return {k: v if k in stacked else gather_tree(v)
            for k, v in params.items()}


def place(params: PyTree, shardings: PyTree) -> PyTree:
    """``params`` as :class:`Placed` leaves: this rank's shard of each
    leaf under its :class:`NamedSharding` (``make_param_shardings``).
    A shard keeps its leaf's dtype, device and ``requires_grad``."""
    def leaf(t: torch.Tensor, s: NamedSharding) -> Placed:
        spec = tuple(s.spec) + (None,) * (t.dim() - len(s.spec))
        with torch.no_grad():
            local = shard_of(t, spec, s.mesh)
            if local is t:               # a whole shard: not the caller's
                local = t.clone()
        return Placed(local.requires_grad_(t.requires_grad), spec,
                      tuple(t.shape), s.mesh)
    return tree_map(leaf, params, shardings)


def shards(tree: PyTree) -> PyTree:
    """The shard tensors of a placed tree."""
    return tree_map(lambda p: p.local, tree)


def like(tree: PyTree, template: PyTree) -> PyTree:
    """Shard tensors ``tree`` placed as ``template``'s leaves."""
    return tree_map(lambda t, p: Placed(t, p.spec, tuple(p.shape), p.mesh),
                    tree, template)


def whole(tree: PyTree) -> PyTree:
    """Every :class:`Placed` leaf gathered, without autograd (checkpoints,
    reports); other leaves as they are."""
    with torch.no_grad():
        return tree_map(lambda p: _gather_value(p.local, p.spec, p.mesh)
                        if isinstance(p, Placed) else p, tree)


def meta_view(tree: PyTree) -> PyTree:
    """``meta`` tensors of the whole leaves' shapes and dtypes (for plans
    and byte counts)."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), tree)


def local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: the leading dim split over the
    mesh's batch axes, ``pod`` outermost."""
    sizes = mesh_shape(mesh)
    spec = (tuple(a for a in BATCH_AXES if a in sizes),)
    ranks = math.prod(sizes[a] for a in spec[0])
    for k, v in batch.items():
        if v.shape[0] % ranks:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {spec[0]} ({ranks} ranks)")
    return {k: shard_of(v, spec, mesh) for k, v in batch.items()}


def global_norm(grads: PyTree, placed: PyTree) -> torch.Tensor:
    """sqrt of the summed squares of the whole gradients, from the shards
    (``grads``, laid out as ``placed``; ``None`` counts as zero): each
    shard's sum over the world, divided by the number of ranks that hold
    a copy of it, in f32."""
    sizes = mesh_shape(_first_leaf(placed).mesh)
    world = math.prod(sizes.values())
    parts = []
    for g, p in zip(leaves(grads), leaves(placed)):
        if g is None:
            continue
        split = 1
        for entry in p.spec:
            for ax in _names(entry):
                split *= sizes[ax]
        parts.append(torch.sum(torch.square(g.to(torch.float32)))
                     * (split / world))
    total = torch.stack(parts).sum()
    dist.all_reduce(total)
    return torch.sqrt(total)


def shard_bytes(tree: PyTree) -> int:
    """Bytes of this rank's shards."""
    return sum(p.local.numel() * p.local.element_size()
               for p in leaves(tree))
