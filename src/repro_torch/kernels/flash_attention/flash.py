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
  raises otherwise.  Head dim 80 runs the 128-wide tile, 16 and 32 the
  64-wide one: the tensor maps keep the real width, TMA zero-fills the
  columns past it, and only the first D output columns are stored.
* f32: the CUDA-core kernel (f32 products, ``expf``), because the f32
  tolerance of 2e-5 cannot be met by a bf16 or TF32 tensor-core product.

CUDA tensors only; the CPU path is :func:`repro_torch.kernels.
flash_attention.ops.attention_plain`, chosen by :mod:`repro_torch.kernels.
flash_attention.ops`.  Launches on the current stream, allocates only its
output, and adds one to ``_build.LAUNCHES["flash_attention"]`` per launch,
whichever the route.  Meta tensors (the dry-run) take a route of their
own, checked as the card's: it launches nothing and counts no launch,
returns outputs of the kernel's shapes and dtypes, and records the call's
operations and bytes (:func:`repro_torch.kernels.costs.flash_cost`,
``flash_bwd_cost``) with ``_build.record_cost``.

Training (:class:`FlashAttentionFn`): the forward also writes each row's
log-sum-exp, and :func:`flash_attention_bwd`, the hand-written backward
(the JAX package has none: it differentiates its plain attention), reads
it.  Bound by operations too, 2.5x the forward's (5 products against 2);
bf16 in one pass on the tensor cores (``wgmma``, TMA, dQ summed in a fixed
order), f32 on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, costs

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (the bf16 route runs 80,
#: hubert-xlarge's, on its 128-wide tile and 16 and 32, the reduced configs'
#: and the examples', on its 64-wide one, with the columns past D
#: zero-filled by TMA)
HEAD_DIMS = (16, 32, 64, 80, 128)
#: query rows a block of the tensor-core route covers (the grid's y extent
#: is Sq / BQ, at most 65535)
BQ = 128
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   *([_L] * 12), ctypes.c_float, _I, _P],
               "flash_attention_bwd": [*([_P] * 10), *([_I] * 7), _P, ctypes.c_float, _I, _P,
                                       _P],
               "flash_attention_bwd_workspace": [*([_I] * 7), _P]}


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every ``(b, s, h)`` row of a ``(B, S, H, D)`` tensor starts
    16-byte aligned: the base address and the batch, sequence and head
    strides (in bytes) of every dim longer than 1 are multiples of 16."""
    size = t.element_size()
    return not (t.data_ptr() % 16
                or any(t.stride(i) * size % 16 for i in range(3) if t.shape[i] > 1))


def check_rows_aligned(*tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every tensor's rows start 16-byte aligned
    (:func:`rows_aligned`), as the tensor-core routes' TMA and 16-byte
    loads need."""
    for t in tensors:
        if not rows_aligned(t):
            raise ValueError(f"flash_attention: rows of a {tuple(t.shape)} tensor with strides "
                             f"{t.stride()} at address {t.data_ptr():#x} do not all start "
                             f"16-byte aligned")


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for t in (q, k, v):
        if t.device.type not in ("cuda", "meta") or t.device != q.device:
            raise ValueError("flash_attention: q, k and v must be on one CUDA device (or all "
                             "on meta)")
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


def _strides(*tensors: torch.Tensor) -> list[int]:
    # a unit dim's stride is never used: pass 0, which the kernel's own
    # alignment check accepts
    return [t.stride(i) if t.shape[i] > 1 else 0 for t in tensors for i in (0, 1, 2)]


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    lse: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of the model layout ``(B, S, H, D)``, read through strides
    (only the last dim must be contiguous); returns a new contiguous
    ``(B, Sq, Hq, D)`` tensor in q's dtype.  Query head ``h`` attends kv head
    ``h // (Hq // Hkv)``; the causal mask is ``q_pos >= k_pos`` from position
    0 of both, as in the JAX kernel.  Any ``Sq``/``Skv`` (ragged tiles are
    masked).  bf16 runs on the tensor cores and needs 16-byte aligned rows
    (:func:`check_rows_aligned`) and a key; f32 runs on the CUDA cores.

    ``lse``, a contiguous f32 ``(B, Hq, Sq)`` tensor, also receives each
    row's log-sum-exp of the scaled scores (natural log; ``-inf`` for a row
    that sees no key), which :func:`flash_attention_bwd` reads.  The
    function is not differentiable itself: an input that requires grad
    while grad is enabled raises (:class:`FlashAttentionFn` is the
    differentiable form)."""
    _build.refuse_grad("flash_attention", q, k, v,
                       why="its backward runs through FlashAttentionFn (ops.attention)")
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if lse is not None and (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention: lse must be a contiguous f32 {(b, hq, sq)} tensor "
                         f"on {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16 and skv < 1:
        raise ValueError("flash_attention: the bf16 route needs at least one key")
    if q.device.type == "meta":  # the dry-run: shapes and the call's cost, no launch
        _build.record_cost("flash_attention", costs.flash_cost(
            b, sq, hq, skv, hkv, d, causal=causal, itemsize=q.element_size(),
            lse=lse is not None))
        return out
    if q.dtype == torch.bfloat16:
        check_rows_aligned(q, k, v, out)
    lib = _build.load("flash_attention", _SIGNATURES)
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype],
        b, hq, hkv, sq, skv, d, *_strides(q, k, v, out),
        scale, int(causal), _build.stream_ptr(q.device),
    )
    _build.LAUNCHES["flash_attention"] += 1
    _build.check(code, "flash_attention")
    return out


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hand-written backward of :func:`flash_attention`: ``(dq, dk,
    dv)``, new contiguous tensors in q's dtype, from the forward's inputs,
    its output ``out``, its ``lse`` and the output's gradient ``dout``
    (every ``(B, S, H, D)`` tensor read through strides with a contiguous
    last dim; bf16 rows 16-byte aligned).  ``delta = rowsum(dout * out)``;
    per kv tile of one kv head, over its group's query heads and the query
    tiles from the causal start, ``P = exp(scale q k^T - lse)``, ``dV +=
    P^T dO``, ``dS = P (dO v^T - delta)``, ``dK += scale dS^T q``, ``dQ +=
    scale dS k``.

    bf16, FlashAttention-3's one pass on the tensor cores: a pre-pass
    (delta, lse in the log2 domain, zeroed f32 dQ sums and counters), one
    kernel of five ``wgmma`` products per tile (a CTA per 128 keys, two
    consumer warpgroups, TMA loads from a producer warp, P and dS rounded
    to bf16 as operands) whose dQ partials a second producer warp adds
    into the f32 sums in ascending kv-tile order, and dQ's rounding to
    bf16 (with GQA a CTA takes one query head and the same launch sums the
    group's f32 dK/dV partials in head order).  The fixed orders make the
    result bitwise repeatable.  f32: three CUDA-core kernels (delta,
    dK/dV, dQ recomputing S and dP).  The workspace
    (``flash_attention_bwd_workspace`` bytes: delta for f32; lse2, delta,
    counters, dQ sums and with GQA the dK/dV partials for bf16) is
    allocated here.  Adds
    one to ``_build.LAUNCHES["flash_attention_bwd"]`` per kernel launched,
    as the entry point reports them: three a call but where a grid is
    empty (the middle one without keys)."""
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    for name, t in (("out", out), ("dout", dout)):
        if (tuple(t.shape) != (b, sq, hq, d) or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1):
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype} "
                             f"{t.stride()} does not match q {tuple(q.shape)} {q.dtype}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous f32 {(b, hq, sq)} "
                         f"tensor on {q.device}")
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if q.device.type == "meta":  # the dry-run: shapes and the call's cost, no launch
        _build.record_cost("flash_attention_bwd", costs.flash_bwd_cost(
            b, sq, hq, skv, hkv, d, causal=causal, itemsize=q.element_size()))
        return dq, dk, dv
    if q.dtype == torch.bfloat16:
        check_rows_aligned(q, k, v, dout)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.load("flash_attention", _SIGNATURES)
    size = ctypes.c_longlong(0)
    code = lib.flash_attention_bwd_workspace(_DTYPE_CODE[q.dtype], b, hq, hkv, sq, skv, d,
                                             ctypes.byref(size))
    _build.check(code, "flash_attention_bwd_workspace")
    work = torch.empty(max(size.value, 1), dtype=torch.uint8, device=q.device)
    strides = (ctypes.c_longlong * 24)(*_strides(q, k, v, out, dout, dq, dk, dv))
    launched = ctypes.c_int(0)
    code = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], b, hq, hkv, sq, skv, d, ctypes.addressof(strides),
        scale, int(causal), _build.stream_ptr(q.device), ctypes.byref(launched),
    )
    _build.LAUNCHES["flash_attention_bwd"] += launched.value
    _build.check(code, "flash_attention_bwd")
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    backward: the forward also writes the row log-sum-exp and saves q, k,
    v, the output and the lse (``B*Hq*Sq`` floats, where the plain
    attention saves its ``Sq x Skv`` scores and softmax).  CUDA tensors
    only; :func:`repro_torch.kernels.flash_attention.ops.attention` takes it
    for a CUDA tensor while grad is enabled and an input requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        b, sq, hq, _ = q.shape
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        out = flash_attention(q, k, v, causal=causal, scale=scale, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or not rows_aligned(dout):  # a layout the kernel cannot read
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None
