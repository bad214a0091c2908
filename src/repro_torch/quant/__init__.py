"""Quantized and sparse storage for the serve path.

* :mod:`repro_torch.quant.quantize` — per-channel symmetric int8 / fp8
  (e4m3) quantization of the decomposed factors and the
  ``k_q``/``k_scale`` tree rewrite; the fused kernels that consume them
  are ``kernels/lowrank_matmul_q`` and ``kernels/branched_matmul_q``.
* :mod:`repro_torch.quant.sparse` — 2:4 packing of the factors
  (``k_sp``/``k_idx``/``k_scale``), int8 / e4m3 or unquantized; the
  quantized packs run ``kernels/lowrank_matmul_sq`` and
  ``kernels/branched_matmul_sq``.
* :mod:`repro_torch.quant.kv` — the runtime int8 KV pool
  (per-(slot, head, channel) scales, running-max decode writes), read by
  ``kernels/decode_attention_q``.
"""
