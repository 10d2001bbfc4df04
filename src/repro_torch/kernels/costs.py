"""Operations and HBM bytes of one call of each hand-written LM kernel,
counted from shapes: the figures ``PERF.md``'s bound column divides by the
card's rates, and what the kernels' meta routes record for the dry-run
(:func:`repro_torch.core.comm_analysis.count_cost`).  One function a
kernel, so the bound and the dry-run cannot drift apart.

Bytes follow the bound's rule: each input read once, each output written
once (scratch is not counted).  Operations follow each kernel's own
convention, stated in its function.  Every function returns ``(flops,
bytes)`` as Python ints, so a count of many calls stays exact.
"""

from __future__ import annotations

__all__ = ["flash_cost", "flash_bwd_cost", "wkv_cost", "wkv_bwd_cost", "wkv_flops",
           "wkv_bwd_flops"]


def flash_cost(b: int, sq: int, hq: int, skv: int, hkv: int, d: int, *, causal: bool,
               itemsize: int, lse: bool = False) -> tuple[int, int]:
    """``flash_attention`` on q ``(b, sq, hq, d)`` and k, v ``(b, skv, hkv,
    d)``: two products of ``2*b*hq*sq*skv*d``, half of the tiles where
    causal; q, k, v read and the output written, plus the f32 ``lse`` rows
    when the training forward writes them."""
    flops = 4 * b * hq * sq * skv * d // (2 if causal else 1)
    nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * itemsize + (
        4 * b * hq * sq if lse else 0)
    return flops, nbytes


def flash_bwd_cost(b: int, sq: int, hq: int, skv: int, hkv: int, d: int, *, causal: bool,
                   itemsize: int) -> tuple[int, int]:
    """``flash_attention_bwd``: five products of ``2*b*hq*sq*skv*d`` (P
    recomputed, dV, dP, dK, dQ), half of the tiles where causal; q, out,
    dout read and dq written, k, v read and dk, dv written, the f32 lse
    read (171.8 GFLOP on 134 MB at (1, 4096, 32, 64) causal bf16)."""
    flops = 5 * 2 * b * hq * sq * skv * d // (2 if causal else 1)
    nbytes = 4 * (b * sq * hq * d + b * skv * hkv * d) * itemsize + 4 * b * hq * sq
    return flops, nbytes


def wkv_flops(rows: int, T: int, c: int, hd: int) -> int:
    """Operations of the chunked scan, counted from shapes per (row, chunk):
    the state term and the state update (2 x 2*c*hd*hd), the pairwise term
    over the strictly lower (t, s) pairs (a subtract, an exponential, two
    multiplies and an add per channel), A.v over the lower triangle with
    the diagonal (2 per product), and the bonus (3*c*hd)."""
    per_chunk = 4 * c * hd * hd + 5 * hd * c * (c - 1) // 2 + c * (c + 1) * hd + 3 * c * hd
    return rows * (T // c) * per_chunk


def wkv_bwd_flops(rows: int, T: int, c: int, hd: int, sb: int = 16) -> int:
    """Operations of the backward, counted from shapes per (row, chunk), in
    the forward's convention (:func:`wkv_flops`), for the leanest design
    known, the kernel's: four state products (dr's and dk's state terms,
    dv's, G's: 4 x 2*c*hd*hd); over the strictly lower (t, s) pairs, on
    the diagonal sub-blocks of ``sb`` rows a channel's decay
    e^(cp_t - cum_s), one subtract and one exponential that the three
    pairwise sums (A, dr's, dk's) share, and in each sum two multiplies and
    an add (11 a pair-channel); off them the decay is factored into the
    operands, so each sum is one multiply-add (6 a pair-channel); B = dy.v
    and dv's A.dy over the lower triangle with the diagonal (2 per product
    each); and the bonus, du and dlw terms (6*c*hd)."""
    pairs = c * (c - 1) // 2
    diag = (c // sb) * sb * (sb - 1) // 2 + (c % sb) * (c % sb - 1) // 2
    per_chunk = (8 * c * hd * hd + hd * (11 * diag + 6 * (pairs - diag))
                 + 2 * 2 * hd * c * (c + 1) // 2 + 6 * c * hd)
    return rows * (T // c) * per_chunk


def wkv_cost(b: int, T: int, h: int, hd: int, c: int, *, itemsize: int, u_numel: int,
             S0: bool = False, states: bool = False) -> tuple[int, int]:
    """``wkv_chunked`` on ``(b, T, h, hd)`` rows in chunks of ``c``
    (:func:`wkv_flops`); r, k, v, lw read and y written, u read, the f32
    final state written, ``S0`` read and the chunk-entry ``states``
    written where given."""
    nbytes = ((5 * b * T * h * hd + u_numel) * itemsize
              + 4 * b * h * hd * hd * (1 + int(S0)) + (4 * b * h * (T // c) * hd * hd
                                                       if states else 0))
    return wkv_flops(b * h, T, c, hd), nbytes


def wkv_bwd_cost(b: int, T: int, h: int, hd: int, c: int, *, itemsize: int, u_numel: int,
                 dS_fin: bool = False, dS0: bool = False) -> tuple[int, int]:
    """``wkv_chunked_bwd`` (:func:`wkv_bwd_flops`; 7.34 GFLOP at (1, 4096,
    32, 64) chunk 64): r, k, v, lw, dy read and dr, dk, dv, dlw written, u
    read and du written, the f32 chunk-entry states read, ``S_fin`` and
    ``dS_fin`` read and ``dS0`` written where given."""
    nbytes = ((9 * b * T * h * hd + 2 * u_numel) * itemsize + 4 * b * h * (T // c) * hd * hd
              + 4 * b * h * hd * hd * (2 * int(dS_fin) + int(dS0)))
    return wkv_bwd_flops(b * h, T, c, hd), nbytes
