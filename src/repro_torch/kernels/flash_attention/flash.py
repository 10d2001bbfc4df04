"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas ``_flash_kernel`` behind ``flash_attention``
(``src/repro/kernels/flash_attention/flash.py``).  Bound by operations on
this card: causal attention over S tokens does about ``2*H*S*S*D`` flops on
``4*H*S*D`` elements, hundreds of flops per byte at prefill lengths.  This
first kernel runs them in f32 on the CUDA cores (not the tensor cores), one
block per (batch, query head, 64-row query tile), K/V tiles staged in
shared memory, online softmax in f32 per row.

CUDA tensors only; the CPU path is :func:`repro_torch.kernels.
flash_attention.ops.attention_plain`, chosen by :mod:`repro_torch.kernels.
flash_attention.ops`.  Launches on the current stream, allocates only its
output, and adds one to ``_build.LAUNCHES["flash_attention"]`` per launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   *([_L] * 12), ctypes.c_float, _I, _P]}


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention of the model layout ``(B, S, H, D)``, read through strides
    (only the last dim must be contiguous); returns a new contiguous
    ``(B, Sq, Hq, D)`` tensor in q's dtype.  Query head ``h`` attends kv head
    ``h // (Hq // Hkv)``; the causal mask is ``q_pos >= k_pos`` from position
    0 of both, as in the JAX kernel.  Any ``Sq``/``Skv`` (ragged tiles are
    masked)."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash_attention: q, k and v must be on one CUDA device")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: tensors must be (B, S, H, D) with a "
                             f"contiguous last dim, got {tuple(t.shape)} {t.stride()}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: {q.dtype}/{k.dtype}/{v.dtype} (f32 or bf16, one dtype)")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if tuple(k.shape) != (b, skv, hkv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv or hq > 65535 or b > 65535:
        raise ValueError(f"flash_attention: {hq} query heads on {hkv} kv heads, batch {b}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention", _SIGNATURES)
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
        b, hq, hkv, sq, skv, d,
        *(t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)),
        scale, int(causal), _build.stream_ptr(q.device),
    )
    _build.LAUNCHES["flash_attention"] += 1
    _build.check(code, "flash_attention")
    return out
