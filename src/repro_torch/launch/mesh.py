"""Production mesh construction over the process group that exists.

Functions, not module-level constants: importing this module touches no
process group.  The caller initialises ``torch.distributed`` (address,
world size and rank given explicitly; a ``FileStore`` needs no port)
before it asks for a mesh.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's
    ranks (row-major), on the card under NCCL, else on the CPU."""
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) = 256-chip pod; (2, 16, 16) = 2 pods = 512 chips.

    ``pod`` is pure data-parallel (the slow inter-pod link is crossed once
    per step by the gradient sync); ``data`` carries DP + FSDP; ``model``
    carries TP / EP / SP.  The world must hold exactly that many ranks.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh() -> DeviceMesh:
    """Whatever ranks exist right now: ``(1, world)`` over ``("data",
    "model")``."""
    return make_mesh((1, dist.get_world_size()), ("data", "model"))
