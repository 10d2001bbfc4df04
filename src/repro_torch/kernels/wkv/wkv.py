"""Wrapper of the hand-written CUDA WKV chunk-scan kernel (``csrc/wkv.cu``).

Replaces the Pallas ``_wkv_kernel`` behind ``wkv_chunked``
(``src/repro/kernels/wkv/wkv.py``) and runs where the JAX RWKV model runs
its jnp ``wkv_scan``.  Bound by the latency of a chunk's dependent phases
(its exponentials were the bound before the factoring).  The kernel cuts
each chunk into 16-row sub-blocks: off-diagonal sub-blocks of the pairwise
matrix A factor into three decays, each ``exp`` of a sum <= 0, and become
small dense products; only the diagonal sub-blocks take a per-pair
exponential (30720 for a 64-row chunk of hd 64 instead of the pairwise
form's 129024).  The ``hd / 16`` column tiles of a head's state run in
thread-block clusters of two CTAs, each pair computing A once and sharing
it through distributed shared memory (rwkv6-1.6b's 32 heads at batch 1 are
then one wave on an H100); each chunk's inputs are copied by ``cp.async``
while earlier chunks compute, and A runs a chunk ahead of the output and
the state update, beside them.  A chunk of 1 (decode)
takes a route of its own that keeps the state in registers and reads and
writes it in 16-byte vectors.  f32 arithmetic throughout.

Beside the Pallas kernel it starts from a given state ``S0`` and returns
the final state, which is what the model's prefill and decode need; decode
calls it with T = c = 1.

CUDA tensors only; the CPU path is :func:`repro_torch.kernels.wkv.ops.
wkv_plain`, chosen by :mod:`repro_torch.kernels.wkv.ops`.  Launches on the
current stream, allocates only its outputs, and adds one to
``_build.LAUNCHES["wkv_chunked"]`` per launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64)
#: the longest chunk the kernel holds in shared memory
MAX_CHUNK = 64
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"wkv_chunked": [*([_P] * 8), *([_I] * 6), *([_L] * 14), _P]}


def _u_strides(u: torch.Tensor, b: int, h: int, hd: int) -> tuple[int, int]:
    """(batch, head) element strides of the bonus: (H, hd) per head, shared
    over the batch, or (B, H, hd) per row."""
    if u.stride(-1) != 1:
        raise ValueError(f"wkv_chunked: u needs a contiguous last dim, got {u.stride()}")
    if tuple(u.shape) == (h, hd):
        return 0, u.stride(0)
    if tuple(u.shape) == (b, h, hd):
        return u.stride(0), u.stride(1)
    raise ValueError(f"wkv_chunked: u {tuple(u.shape)} is neither ({h}, {hd}) nor ({b}, {h}, {hd})")


def wkv_chunked(
    r: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,  # (B, T, H, hd) log decays (< 0)
    u: torch.Tensor,  # (H, hd) or (B, H, hd)
    *,
    chunk: int = 16,
    S0: torch.Tensor | None = None,  # (B, H, hd, hd) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV of the model layout, read through strides (only the last dim must
    be contiguous), in chunks of ``c = min(chunk, T)``.  Returns ``(y,
    S_fin)``: y a new contiguous ``(B, T, H, hd)`` tensor in r's dtype,
    S_fin a new ``(B, H, hd, hd)`` f32 tensor.  ``T`` must be a multiple of
    ``c``, as in the JAX scan."""
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"wkv_chunked: {name} must be on the CUDA device of r, got {t.device}")
        if t.dtype != r.dtype:
            raise TypeError(f"wkv_chunked: {name} is {t.dtype}, r is {r.dtype} (one dtype)")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"wkv_chunked: {r.dtype} (f32 or bf16)")
    b, T, h, hd = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        if tuple(t.shape) != (b, T, h, hd) or t.stride(-1) != 1:
            raise ValueError(f"wkv_chunked: {name} {tuple(t.shape)} {t.stride()} is not "
                             f"({b}, {T}, {h}, {hd}) with a contiguous last dim")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv_chunked: head size {hd} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535 or T == 0:
        raise ValueError(f"wkv_chunked: batch {b}, heads {h}, length {T}")
    c = min(chunk, T)
    if c <= 0 or T % c:
        raise ValueError(f"wkv: sequence length {T} is not a multiple of the chunk {c}")
    if c > MAX_CHUNK:
        raise ValueError(f"wkv_chunked: chunk {c} above the kernel's {MAX_CHUNK}")
    usb, ush = _u_strides(u, b, h, hd)
    if S0 is not None and (S0.device != r.device or S0.dtype != torch.float32
                           or tuple(S0.shape) != (b, h, hd, hd) or not S0.is_contiguous()):
        raise ValueError(f"wkv_chunked: S0 must be a contiguous ({b}, {h}, {hd}, {hd}) f32 "
                         f"tensor on {r.device}, got {tuple(S0.shape)} {S0.dtype} {S0.device}")
    y = torch.empty((b, T, h, hd), dtype=r.dtype, device=r.device)
    S_fin = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    lib = _build.load("wkv", _SIGNATURES)
    code = lib.wkv_chunked(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        None if S0 is None else S0.data_ptr(), y.data_ptr(), S_fin.data_ptr(),
        _DTYPE_CODE[r.dtype], b, T, h, hd, c,
        *(t.stride(i) for t in (r, k, v, lw) for i in (0, 1, 2)), usb, ush,
        _build.stream_ptr(r.device),
    )
    _build.LAUNCHES["wkv_chunked"] += 1
    _build.check(code, "wkv_chunked")
    return y, S_fin

