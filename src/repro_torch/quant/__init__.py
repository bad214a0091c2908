"""Quantized storage for the serve path.

* :mod:`repro_torch.quant.quantize` — per-channel symmetric int8 / fp8
  (e4m3) quantization of the decomposed factors and the
  ``k_q``/``k_scale`` tree rewrite; the fused kernels that consume them
  are ``kernels/lowrank_matmul_q`` and ``kernels/branched_matmul_q``.
* :mod:`repro_torch.quant.kv` — the runtime int8 KV pool
  (per-(slot, head, channel) scales, running-max decode writes), read by
  ``kernels/decode_attention_q``.

2:4 sparsity comes with ROADMAP item A11.
"""
