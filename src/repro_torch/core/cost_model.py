"""The activation-stream accounting of the cost model, as far as the
act-quant prefill path needs it.

The port's copies of the reference's ``plan_qa_eligible`` and
``plan_act_stream_bytes`` (``repro/core/cost_model.py``).  The roofline
time model that uses them (``plan_layer_time``), the hardware table and
Algorithm 1's ``search`` rank mode wait for an H100 hardware spec
(ROADMAP item A2).
"""
from __future__ import annotations


def plan_qa_eligible(plan, act_quantize: bool = True) -> bool:
    """Does the whole chain run int8 x int8 with act-quant on: every
    factor quantized, dense (no 2:4 pack: sparse plans never take the qa
    kernels), with 1-byte values?  As in the reference, the test is the
    value's byte width, so it also says yes for fp8 factors, which
    :meth:`repro_torch.layers.plan.LinearPlan.kernel_for` keeps on the
    weight-only kernels (a quirk of the reference, kept)."""
    return act_quantize and all(
        f.quantized and f.sparsity is None and f.dtype.itemsize == 1
        for f in plan.chain_factors())


def plan_act_stream_bytes(plan, *, act_bytes: int = 2,
                          act_quantize: bool = False) -> float:
    """Per-token activation bytes of one linear: its input and output
    rows at ``act_bytes``, narrowed to int8 values plus one f32 scale
    per row when the chain is qa-eligible."""
    if plan_qa_eligible(plan, act_quantize):
        act_bytes = 1 + 4.0 / max(1, plan.d_in)
    return act_bytes * (plan.d_in + plan.d_out)
