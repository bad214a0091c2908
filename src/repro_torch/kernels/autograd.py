"""Autograd of the two chain kernels on the training path: B1
``lowrank_matmul`` and B2 ``branched_matmul``.

The reference has no backward kernel: it trains with ``use_pallas=False``
(``repro/configs/base.py:229``), so its backward products are XLA dots
outside any Pallas kernel.  Here the forward is the hand-written kernel
unchanged (bf16: the split-phase tensor-core kernel, or the large-M form
at ``branched_matmul.LARGE_M`` rows or more; f32: the f32 form; a
CPU tensor: the plain version), and the backward is the chain's
transposed products written out in ``torch.matmul``
(:func:`lowrank_matmul_bwd`, :func:`branched_matmul_bwd`).  They form
only the gradients ``ctx.needs_input_grad`` asks for, so a factor that
the freeze policy detached (``core/freezing.py``) gets no cotangent, and
they recompute the rank intermediates in ``x.dtype``, rounded where the
forward rounds them.  The backward never calls the plain versions of
``kernels/ref.py``.

Each forward goes through a ``torch.library`` op
(``repro_torch::lowrank_matmul`` / ``repro_torch::branched_matmul``):
one dispatcher call whose output a selective-checkpoint policy can keep
(``models/lm.py``'s ``remat="dots"``), so a recomputed block takes the
kept output and does not launch the kernel again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import lowrank_matmul as lk
from repro_torch.kernels import ref


@torch.library.custom_op("repro_torch::lowrank_matmul", mutates_args=())
def lowrank_matmul_op(x: torch.Tensor, w0: torch.Tensor,
                      w1: torch.Tensor) -> torch.Tensor:
    """The forward: the kernel on a CUDA tensor, the plain version on a
    CPU one.  x (M, C) contiguous."""
    if x.device.type == "cpu":
        return ref.lowrank_matmul_ref(x, w0, w1)
    return lk.lowrank_matmul(x, w0, w1)


@torch.library.custom_op("repro_torch::branched_matmul", mutates_args=())
def branched_matmul_op(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The forward of the branched chain, as :func:`lowrank_matmul_op`."""
    if x.device.type == "cpu":
        return ref.branched_matmul_ref(x, u, xc, v)
    return bk.branched_matmul(x, u, xc, v)


@lowrank_matmul_op.register_fake
def _(x, w0, w1):
    """The output's shape and dtype without a value (``FakeTensorMode``:
    the dry run)."""
    return x.new_empty((x.shape[0], w1.shape[-1]))


@branched_matmul_op.register_fake
def _(x, u, xc, v):
    return x.new_empty((x.shape[0], v.shape[-1]))


#: the forward ops, for a selective-checkpoint policy that keeps them
KERNEL_OPS = (torch.ops.repro_torch.lowrank_matmul.default,
              torch.ops.repro_torch.branched_matmul.default)


def lowrank_matmul_bwd(g: torch.Tensor, x: torch.Tensor, w0: torch.Tensor,
                       w1: torch.Tensor, needs=(True, True, True)
                       ) -> tuple[torch.Tensor | None, ...]:
    """``(dx, dw0, dw1)`` of ``y = rnd(rnd(x @ w0) @ w1)`` for the
    cotangent ``g`` (M, S); ``needs`` says which to form (None for the
    others).  ``h = x @ w0`` is recomputed in ``x.dtype``."""
    need_x, need_w0, need_w1 = needs
    g = g.to(x.dtype)
    dx = dw0 = dw1 = None
    if need_w1:
        dw1 = torch.matmul(torch.matmul(x, w0).t(), g)
    if need_x or need_w0:
        dh = torch.matmul(g, w1.t())
        if need_x:
            dx = torch.matmul(dh, w0.t())
        if need_w0:
            dw0 = torch.matmul(x.t(), dh)
    return dx, dw0, dw1


def branched_matmul_bwd(g: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
                        xc: torch.Tensor, v: torch.Tensor,
                        needs=(True, True, True, True)
                        ) -> tuple[torch.Tensor | None, ...]:
    """``(dx, du, dxc, dv)`` of ``y = rnd(sum_n rnd(rnd(x @ u_n) @ xc_n)
    @ v_n)`` for the cotangent ``g`` (M, S); ``needs`` as for
    :func:`lowrank_matmul_bwd`.  ``h1_n = x @ u_n`` and ``h2_n = h1_n @
    xc_n`` are recomputed in ``x.dtype``; dx sums the branches in one
    product."""
    need_x, need_u, need_xc, need_v = needs
    g = g.to(x.dtype)
    dx = du = dxc = dv = None
    h1 = torch.matmul(x, u) if (need_xc or need_v) else None   # (N, M, r1)
    if need_v:
        dv = torch.matmul(torch.matmul(h1, xc).transpose(1, 2), g)
    if need_x or need_u or need_xc:
        dh2 = torch.matmul(g, v.transpose(1, 2))                # (N, M, r2)
        if need_xc:
            dxc = torch.matmul(h1.transpose(1, 2), dh2)
        if need_x or need_u:
            dh1 = torch.matmul(dh2, xc.transpose(1, 2))         # (N, M, r1)
            if need_u:
                du = torch.matmul(x.t(), dh1)
            if need_x:
                dx = torch.einsum("nmr,ncr->mc", dh1, u)
    return dx, du, dxc, dv


class LowrankMatmul(torch.autograd.Function):
    """B1 under autograd: the kernel forward, :func:`lowrank_matmul_bwd`
    backward."""

    @staticmethod
    def forward(ctx, x, w0, w1):
        ctx.save_for_backward(x, w0, w1)
        return lowrank_matmul_op(x, w0, w1)

    @staticmethod
    def backward(ctx, g):
        return lowrank_matmul_bwd(g, *ctx.saved_tensors,
                                  needs=ctx.needs_input_grad)


class BranchedMatmul(torch.autograd.Function):
    """B2 under autograd: the kernel forward, :func:`branched_matmul_bwd`
    backward."""

    @staticmethod
    def forward(ctx, x, u, xc, v):
        ctx.save_for_backward(x, u, xc, v)
        return branched_matmul_op(x, u, xc, v)

    @staticmethod
    def backward(ctx, g):
        return branched_matmul_bwd(g, *ctx.saved_tensors,
                                   needs=ctx.needs_input_grad)
