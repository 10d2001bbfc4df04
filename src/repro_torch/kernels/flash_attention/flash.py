"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas ``_flash_kernel`` behind ``flash_attention``
(``src/repro/kernels/flash_attention/flash.py``).  Bound by operations on
this card: causal attention over S tokens does about ``2*H*S*S*D`` flops on
``4*H*S*D`` elements, hundreds of flops per byte at prefill lengths.  The
route is chosen by dtype, never on an error:

* bf16 (the serving path): both products on the tensor cores as
  warpgroup MMAs (``wgmma``, f32 accumulation), two warpgroups of 64 query
  rows a block sharing K/V tiles of 64 keys that TMA loads into a 2-stage
  ring.  Every row of q, k, v and the output must start 16-byte aligned
  (:func:`check_rows_aligned`), and k needs at least one key; the wrapper
  raises otherwise.  Head dim 80 runs the 128-wide tile: the tensor maps
  keep the real width, TMA zero-fills the columns past it, and only the
  first 80 output columns are stored.
* f32: the CUDA-core kernel (f32 products, ``expf``), because the f32
  tolerance of 2e-5 cannot be met by a bf16 or TF32 tensor-core product.

CUDA tensors only; the CPU path is :func:`repro_torch.kernels.
flash_attention.ops.attention_plain`, chosen by :mod:`repro_torch.kernels.
flash_attention.ops`.  Launches on the current stream, allocates only its
output, and adds one to ``_build.LAUNCHES["flash_attention"]`` per launch,
whichever the route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (80, hubert-xlarge's, runs the
#: bf16 route's 128-wide tile with the columns past 80 zero-filled by TMA)
HEAD_DIMS = (64, 80, 128)
#: query rows a block of the tensor-core route covers (the grid's y extent
#: is Sq / BQ, at most 65535)
BQ = 128
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   *([_L] * 12), ctypes.c_float, _I, _P]}


def check_rows_aligned(*tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every ``(b, s, h)`` row of each
    ``(B, S, H, D)`` tensor starts 16-byte aligned: the base address and the
    batch, sequence and head strides (in bytes) of every dim longer than 1
    are multiples of 16, as the tensor-core route's TMA loads need."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) * size % 16 for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"flash_attention: rows of a {tuple(t.shape)} tensor with strides "
                             f"{t.stride()} at address {t.data_ptr():#x} do not all start "
                             f"16-byte aligned")


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
    masked).  bf16 runs on the tensor cores and needs 16-byte aligned rows
    (:func:`check_rows_aligned`) and a key; f32 runs on the CUDA cores."""
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
    if -(-sq // BQ) > 65535:
        raise ValueError(f"flash_attention: {sq} query rows (at most {65535 * BQ})")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        if skv < 1:
            raise ValueError("flash_attention: the bf16 route needs at least one key")
        check_rows_aligned(q, k, v, out)
    lib = _build.load("flash_attention", _SIGNATURES)
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
        b, hq, hkv, sq, skv, d,
        # a unit dim's stride is never used: pass 0, which the kernel's own
        # alignment check accepts
        *(t.stride(i) if t.shape[i] > 1 else 0 for t in (q, k, v, out) for i in (0, 1, 2)),
        scale, int(causal), _build.stream_ptr(q.device),
    )
    _build.LAUNCHES["flash_attention"] += 1
    _build.check(code, "flash_attention")
    return out
