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
``_build.LAUNCHES["wkv_chunked"]`` per launch.  Meta tensors (the dry-run)
take a route of their own, checked as the card's: it launches nothing and
counts no launch, returns outputs of the kernel's shapes and dtypes (the
chunk-entry states and du included), and records the call's operations
and bytes (:func:`repro_torch.kernels.costs.wkv_cost`, ``wkv_bwd_cost``)
with ``_build.record_cost``.

Training (:class:`WkvChunkedFn`): the forward also writes each chunk's
entry state, and :func:`wkv_chunked_bwd`, the hand-written backward (the
JAX package has none: XLA differentiates its jnp scan), reads them.  Only
the gradient dS of the state crosses chunks, elementwise once each chunk's
``G = (r e^cp)^T dy`` is known, so a call is three kernels: every chunk's
G at once, a reverse scan of dS over the chunks, then every chunk's
gradients at once, each chunk in the forward's factored 16-row sub-blocks
(dense 4 x 4 register-tiled products off the diagonal, Horner over the
sub-blocks for the state terms, an exponential per pair only on the
diagonal), f32 on the CUDA cores; the log decay's gradient by its closed
form, whose sum over later chunks telescopes to ``rowsum(S_out dS_out)``
(``ref.wkv_bwd_plain`` writes the passes out).  Bound by operations.
Bitwise repeatable: every sum in a fixed order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, costs

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64)
#: the longest chunk the kernel holds in shared memory
MAX_CHUNK = 64
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"wkv_chunked": [*([_P] * 9), *([_I] * 6), *([_L] * 14), _P],
               "wkv_chunked_bwd": [*([_P] * 16), *([_I] * 6), _L, _L, _P]}


def _check_f32(t: torch.Tensor, shape: tuple, device: torch.device, name: str) -> None:
    if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"wkv_chunked: {name} must be a contiguous {shape} f32 tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} {t.device}")


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


def _check_inputs(what: str, chunk: int, u: torch.Tensor, **rows: torch.Tensor) -> tuple:
    """The checks the forward and the backward share: ``u`` and the
    ``(B, T, H, hd)`` tensors ``rows`` (r first) on r's CUDA device in its
    dtype (f32 or bf16), the rows of one shape with a contiguous last dim,
    a head size the kernels are built for, the grid's limits and the
    chunk; returns ``(B, T, H, hd, c)``."""
    r = next(iter(rows.values()))
    for name, t in (*rows.items(), ("u", u)):
        if t.device.type not in ("cuda", "meta") or t.device != r.device:
            raise ValueError(f"{what}: {name} must be on the CUDA device of r, got {t.device}")
        if t.dtype != r.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, r is {r.dtype} (one dtype)")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: {r.dtype} (f32 or bf16)")
    b, T, h, hd = r.shape
    for name, t in rows.items():
        if tuple(t.shape) != (b, T, h, hd) or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.stride()} is not "
                             f"({b}, {T}, {h}, {hd}) with a contiguous last dim")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head size {hd} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535 or T == 0:
        raise ValueError(f"{what}: batch {b}, heads {h}, length {T}")
    return b, T, h, hd, chunk_of(T, chunk)


def chunk_of(T: int, chunk: int) -> int:
    """The chunk ``c = min(chunk, T)`` the kernels take; ``ValueError``
    unless ``T`` is a multiple of it and it fits the kernel."""
    c = min(chunk, T)
    if c <= 0 or T % c:
        raise ValueError(f"wkv: sequence length {T} is not a multiple of the chunk {c}")
    if c > MAX_CHUNK:
        raise ValueError(f"wkv_chunked: chunk {c} above the kernel's {MAX_CHUNK}")
    return c


def wkv_chunked(
    r: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,  # (B, T, H, hd) log decays (< 0)
    u: torch.Tensor,  # (H, hd) or (B, H, hd)
    *,
    chunk: int = 16,
    S0: torch.Tensor | None = None,  # (B, H, hd, hd) f32
    states: torch.Tensor | None = None,  # (B, H, T/c, hd, hd) f32, written
) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV of the model layout, read through strides (only the last dim must
    be contiguous), in chunks of ``c = min(chunk, T)``.  Returns ``(y,
    S_fin)``: y a new contiguous ``(B, T, H, hd)`` tensor in r's dtype,
    S_fin a new ``(B, H, hd, hd)`` f32 tensor.  ``T`` must be a multiple of
    ``c``, as in the JAX scan.  ``states``, a contiguous f32 ``(B, H, T/c,
    hd, hd)`` tensor, also receives each chunk's entry state (``S0`` first),
    which :func:`wkv_chunked_bwd` reads.  Not differentiable itself: an
    input that requires grad while grad is enabled raises
    (:class:`WkvChunkedFn` is the differentiable form)."""
    b, T, h, hd, c = _check_inputs("wkv_chunked", chunk, u, r=r, k=k, v=v, lw=lw)
    _build.refuse_grad("wkv_chunked", r, k, v, lw, u, *(() if S0 is None else (S0,)),
                       why="its backward runs through WkvChunkedFn (ops.wkv)")
    usb, ush = _u_strides(u, b, h, hd)
    if S0 is not None and (S0.device != r.device or S0.dtype != torch.float32
                           or tuple(S0.shape) != (b, h, hd, hd) or not S0.is_contiguous()):
        raise ValueError(f"wkv_chunked: S0 must be a contiguous ({b}, {h}, {hd}, {hd}) f32 "
                         f"tensor on {r.device}, got {tuple(S0.shape)} {S0.dtype} {S0.device}")
    if states is not None:
        _check_f32(states, (b, h, T // c, hd, hd), r.device, "states")
    y = torch.empty((b, T, h, hd), dtype=r.dtype, device=r.device)
    S_fin = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    if r.device.type == "meta":  # the dry-run: shapes and the call's cost, no launch
        _build.record_cost("wkv_chunked", costs.wkv_cost(
            b, T, h, hd, c, itemsize=r.element_size(), u_numel=u.numel(), S0=S0 is not None,
            states=states is not None))
        return y, S_fin
    lib = _build.load("wkv", _SIGNATURES)
    code = lib.wkv_chunked(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        None if S0 is None else S0.data_ptr(), y.data_ptr(), S_fin.data_ptr(),
        None if states is None else states.data_ptr(),
        _DTYPE_CODE[r.dtype], b, T, h, hd, c,
        *(t.stride(i) for t in (r, k, v, lw) for i in (0, 1, 2)), usb, ush,
        _build.stream_ptr(r.device),
    )
    _build.LAUNCHES["wkv_chunked"] += 1
    _build.check(code, "wkv_chunked")
    return y, S_fin


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the backward's vector loads
    read it: ``t`` itself, or a copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def bwd_workspace_floats(b: int, T: int, h: int, hd: int, c: int) -> int:
    """f32 scratch of one :func:`wkv_chunked_bwd` call, in floats: each
    chunk's G and then its dS ``(B, H, T/c, hd, hd)``, its ``e^tot`` and its
    part of du ``(B, H, T/c, hd)`` (34.6 MB at rwkv6-1.6b's training shape
    (1, 4096, 32, 64), chunk 64)."""
    return b * h * (T // c) * (hd * hd + 2 * hd)


def wkv_chunked_bwd(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,
    u: torch.Tensor,
    dy: torch.Tensor,  # (B, T, H, hd), the gradient of y
    states: torch.Tensor,  # (B, H, T/c, hd, hd) f32, the forward's
    *,
    chunk: int = 16,
    S_fin: torch.Tensor | None = None,  # (B, H, hd, hd) f32, the forward's
    dS_fin: torch.Tensor | None = None,  # (B, H, hd, hd), the gradient of S_fin
    want_dS0: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The hand-written backward of :func:`wkv_chunked`: ``(dr, dk, dv,
    dlw, du, dS0)`` from the forward's inputs, its chunk-entry ``states``
    and, when ``dS_fin`` is given, its final state ``S_fin``.  dr, dk, dv,
    dlw are new contiguous ``(B, T, H, hd)`` tensors in r's dtype, du in
    u's shape and dtype (a per-head u's gradient summed over the batch in
    a fixed order), dS0 a ``(B, H, hd, hd)`` f32 tensor when ``want_dS0``,
    else None.  Three kernels (each chunk's G, the dS scan, each chunk's
    gradients) and f32 scratch of :func:`bwd_workspace_floats`, counted as
    one launch in ``_build.LAUNCHES["wkv_chunked_bwd"]``."""
    b, T, h, hd, c = _check_inputs("wkv_chunked_bwd", chunk, u, r=r, k=k, v=v, lw=lw, dy=dy)
    usb, ush = _u_strides(u, b, h, hd)
    _check_f32(states, (b, h, T // c, hd, hd), r.device, "states")
    if dS_fin is not None:
        if S_fin is None:
            raise ValueError("wkv_chunked_bwd: dS_fin needs the forward's S_fin")
        _check_f32(S_fin, (b, h, hd, hd), r.device, "S_fin")
        dS_fin = dS_fin.float().contiguous()
        _check_f32(dS_fin, (b, h, hd, hd), r.device, "dS_fin")
        S_fin, dS_fin = _aligned(S_fin), _aligned(dS_fin)
    states = _aligned(states)
    r, k, v, lw, dy = (_aligned(t) for t in (r, k, v, lw, dy))  # the kernel's layout
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    dS0 = (torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device) if want_dS0
           else None)
    if r.device.type == "meta":  # the dry-run: the call's cost, no launch
        _build.record_cost("wkv_chunked_bwd", costs.wkv_bwd_cost(
            b, T, h, hd, c, itemsize=r.element_size(), u_numel=u.numel(),
            dS_fin=dS_fin is not None, dS0=want_dS0))
    else:
        work = torch.empty(bwd_workspace_floats(b, T, h, hd, c), dtype=torch.float32,
                           device=r.device)
        lib = _build.load("wkv", _SIGNATURES)
        code = lib.wkv_chunked_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
            dy.data_ptr(), states.data_ptr(), None if dS_fin is None else S_fin.data_ptr(),
            None if dS_fin is None else dS_fin.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dlw.data_ptr(), du.data_ptr(),
            None if dS0 is None else dS0.data_ptr(), work.data_ptr(), _DTYPE_CODE[r.dtype],
            b, T, h, hd, c, usb, ush, _build.stream_ptr(r.device),
        )
        _build.LAUNCHES["wkv_chunked_bwd"] += 1
        _build.check(code, "wkv_chunked_bwd")
    if u.dim() == 2:
        du = torch.sum(du, dim=0)  # over the batch, in a fixed order
    return dr, dk, dv, dlw, du.to(u.dtype), dS0


class WkvChunkedFn(torch.autograd.Function):
    """:func:`wkv_chunked` with :func:`wkv_chunked_bwd` as its backward:
    the forward also writes each chunk's entry state, ``(B, H, T/c, hd,
    hd)`` f32 (33.5 MB at rwkv6-1.6b's training shape (1, 4096, 32, 64),
    chunk 64), and saves it with r, k, v, lw, u and the final state.
    ``apply(r, k, v, lw, u, S0, chunk)`` returns ``(y, S_fin)``; a gradient
    on S_fin is taken (the sequence-parallel segment operator's), and the
    gradient of ``S0`` is returned when it requires one.  CUDA tensors
    only; :func:`repro_torch.kernels.wkv.ops.wkv` takes it for a CUDA
    tensor while grad is enabled and an input requires grad."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, S0, chunk: int):
        b, T, h, hd = r.shape
        states = torch.empty((b, h, T // chunk_of(T, chunk), hd, hd), dtype=torch.float32,
                             device=r.device)
        y, S_fin = wkv_chunked(r, k, v, lw, u, chunk=chunk, S0=S0, states=states)
        ctx.save_for_backward(r, k, v, lw, u, states, S_fin)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, S_fin

    @staticmethod
    def backward(ctx, dy, dS_fin):
        r, k, v, lw, u, states, S_fin = ctx.saved_tensors
        # y unused: zeros; an expanded or strided gradient: the kernel's layout
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        dr, dk, dv, dlw, du, dS0 = wkv_chunked_bwd(
            r, k, v, lw, u, dy, states, chunk=ctx.chunk, S_fin=S_fin, dS_fin=dS_fin,
            want_dS0=ctx.needs_input_grad[5])
        return dr, dk, dv, dlw, du, dS0, None
