"""PyTorch/CUDA port of the low-rank-decomposition serving stack.

Mirrors the reference package's module names (``configs``, ``core``,
``layers``, ``kernels``, ``models``, ``serve``) and its param-tree layout
(nested dicts, ``(d_in, d_out)`` weights, ``w`` / ``w0``+``w1`` /
``u``+``xc``+``v`` keys), so :mod:`repro_torch.bridge` can move any
reference tree in and parity tests compare key for key.  Imports
``torch`` only.
"""
