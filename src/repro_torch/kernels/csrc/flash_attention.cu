// Flash (online-softmax) attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention/flash.py (flash_attention): softmax(q k^T
// * scale) v per query head, with query head h reading kv head h / group
// (GQA, a coordinate of the kv tensor map or a pointer offset, no copy of
// K/V), the causal mask q_pos >= k_pos counted from 0 for both, running max
// / denominator / accumulator in f32, and the output divided by max(l,
// 1e-30) so a row that sees no key stays finite.  q, k, v and o are read
// and written through (batch, seq, head) strides in the model layout (B, S,
// H, D); any Sq/Skv (ragged tiles are masked); D is 16, 32, 64, 80 or 128.
//
// What bounds it on this card: operations.  Causal attention over S tokens
// does about 2*H*S*S*D flops (two products, half the tiles) on 4*H*S*D
// elements, hundreds of flops per byte at prefill lengths, so the products
// belong on the tensor cores.  Two routes, chosen by dtype, never on an
// error:
//
// * bf16 (the serving path): flash_tc_kernel, both products as warpgroup
//   MMAs (wgmma, bf16 x bf16 -> f32), the FlashAttention-3 layout without
//   its warp specialisation.
//     - A block is two warpgroups over 128 query rows of one head, 64 rows
//       each (wgmma's M); within a warpgroup warp w owns 16 rows.  The K/V
//       tiles of 64 keys it loads serve both warpgroups.  A warpgroup skips
//       the compute of a tile wholly in its own causal future.
//     - Loads are TMA: one thread issues the Q tile and each K/V tile as
//       64-column boxes of a 4-d tensor map (d, seq, head, batch) built on
//       the host per call, 128-byte swizzled, completion counted on an
//       mbarrier.  K/V go through a 2-stage ring, so tiles t+1 and t+2 are
//       in flight while tile t computes; a stage is refilled after the
//       block's barrier at the end of its tile.  Rows past Sq or Skv are
//       out of the map's bounds and arrive as zeros.
//     - S = Q K^T: wgmma m64n64k16, A = Q and B = K straight from the
//       swizzled shared tiles through matrix descriptors (K-major), f32 in
//       registers.  After the online-softmax rescale P is rounded to bf16
//       pairs in registers and is wgmma's register A operand for O += P V
//       (m64n{D}k16) as it stands (its C and A fragments share the thread
//       layout of mma.m16n8k16); B = V from shared memory, MN-major through
//       the transpose-B bit: no shared-memory round trip for P and no
//       transposing copy of V.  The 128-byte swizzle (16-byte chunk XOR
//       row % 8) that TMA writes is the one the descriptors read, so
//       neither side meets bank conflicts.
//     - Softmax in the log2 domain (ex2.approx, scale * log2(e) applied to
//       the f32 scores); row max over the 4 lanes of a quad (shfl_xor 1, 2);
//       row sums kept per thread and reduced once at the end.  A masked
//       score is -1e30 and its p is exactly 0 (2^-1e30 flushes to 0), also
//       while a row has seen no key (its max is then taken as 0), so fully
//       masked rows stay finite.  Only tiles that cross the diagonal or the
//       ragged end of Skv test the mask.
//     - Causal: tiles wholly in the future are not loaded, and the grid runs
//       the last query tiles (the longest rows) first.
//     - Numerics against the plain version: Q K^T on bf16 operands with f32
//       accumulation (exact products, another summation order); P is
//       rounded to bf16 (2^-9 relative) before P V, where the plain version
//       keeps it in f32; the output is rounded to bf16 (2^-8) anyway.
//     - Every row of q, k, v and o must start 16-byte aligned (TMA's
//       requirement; the wrapper checks and raises).
//     - ptxas (sm_90a, CUDA 12.8, -O3): 128 registers for D = 128 and 97
//       for D = 64, no spills, so two blocks (16 warps) share an SM; shared
//       memory 97 KB a block at D = 128.
//     - D = 80 (hubert-xlarge's 1280 / 16) runs the D = 128 tile: the tile
//       width DT and the real D are separate template parameters.  The
//       tensor maps keep their global extent at D (a 160-byte row stride, a
//       multiple of 16), so TMA fills columns 80-127 of the second box with
//       zeros; Q K^T runs only the k-steps that hold real columns (5 of 8),
//       P V runs the DT-wide product, whose zero columns are never stored;
//       the scale is the caller's (1 / sqrt(80)).  D is a compile-time value
//       because a runtime one (the k-step and store tests left in the
//       code) cost the D = 128 kernel 48 bytes of spills and serialized its
//       wgmma (ptxas).  A tighter design (m64n80k16 for P V, a
//       16-column second box) is later work.
//     - D = 16 and 32 (the reduced configs' and the examples' head dims) run
//       the 64-wide tile the same way: the tensor maps' global extent is D
//       (a 32- or 64-byte row, whose strides stay multiples of 16), the one
//       64-column box reaches past it and TMA fills columns D-63 with zeros
//       (the box's bytes, zeros included, are what the mbarrier counts); Q
//       K^T issues 1 or 2 of its 4 k-steps, P V the whole 64 columns, and
//       only the first D are stored.  A narrower wgmma (m64n16k16,
//       m64n32k16) would skip the zero columns' work; it is later work.
// * f32: flash_kernel, the first CUDA-core kernel of the port, unchanged in
//   its arithmetic (D = 80: 5 accumulator columns a thread, 48.6 KB of
//   shared memory; D = 16 and 32: 1 and 2).  The f32 tolerance (2e-5
//   against the plain version) cannot
//   be met by a bf16 or TF32 tensor-core product; f32 is what the tests and
//   f32 checks use, not the serving path.  One block per (64-row query
//   tile, head, batch), K/V tiles of 32 keys in shared memory, scores and
//   the (64, D) accumulator in registers, P through shared memory, expf
//   (not __expf) to stay within 2e-5.
//
// Both routes can also write each row's log-sum-exp of the scaled scores,
// lse = m + log(l) in natural log (-inf for a row that sees no key), f32
// (B, Hq, Sq); a null pointer skips it, as serving passes.
//
// flash_attention_bwd: the backward, which the JAX package does not have
// (it differentiates its plain attention with XLA; the port's training
// needs one because its forward is this kernel, whose output has no
// autograd graph).  What bounds it: operations, 2.5x the forward's (5
// products against 2).  Bitwise repeatable on both routes.
// * bf16: FlashAttention-3's backward in one pass, three launches:
//   1. bwd_prep_kernel: per row delta = rowsum(dO * O) and lse2 = lse *
//      log2(e) (+inf for a row past Sq or one that saw no key, so its p is
//      0), in (B, Hq, Sq_pad) rows padded to the query tile, delta 0 past
//      Sq; it zeroes the f32 dQ sums and one counter per query tile;
//   2. bwd_tc_kernel, the one pass: a CTA owns BC = 128 keys of one kv
//      head and walks the query tiles of its query head from the causal
//      start (with GQA one of the group's heads, below).  Consumer
//      warpgroup w owns keys 64 w .. + 63 (wgmma's M).  Per tile of BR
//      query rows, five products: S^T = K Q^T and dP^T = V dO^T (both
//      operands K-major from the swizzled tiles), P^T = exp2(scale log2(e)
//      S^T - lse2) and dS^T = P^T (dP^T - delta) in registers, dV += P^T
//      dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as register A
//      operands (C and A fragments share a layout) and dO, Q read MN-major
//      through the transpose bit; dS^T also goes to shared memory as bf16
//      in TMA's 128-byte swizzle, and the partial dQ = dS K over the CTA's
//      128 keys is one wgmma per warpgroup with A = dS^T read MN-major
//      (transposed) and B = K MN-major: at D = 64 warpgroup w takes query
//      rows 64 w .. + 63, at the 128-wide tile columns 64 w .. + 63.
//      Producer warpgroup: warp 8 keeps a 2-stage ring of TMA loads in
//      flight (Q and dO as 64-column boxes of a 4-d tensor map, 128-byte
//      swizzle; lse2 and delta rows as 1-d bulk copies of the padded rows,
//      so a tile past Sq reads nothing past their end), K and V once an
//      item; warp 9 adds each partial dQ, which the consumers leave in one
//      of two shared buffers in their fragment order, into the f32 scratch
//      with one bulk reduce-add of BR x DT floats into L2
//      (cp.reduce.async.bulk .add.f32).  setmaxnreg gives the consumers 240
//      registers a thread and the producers 24.
//   3. bwd_finish_kernel: dq = bf16(scale * the sum); with GQA also dK and
//      dV, the sums over the group's query heads of f32 partials (below).
//   The ordered dQ sum: the partials of one (batch, head, query tile) are
//   added in ascending kv tile order.  Warp 9 of the CTA at kv tile j waits
//   until the tile's counter equals j, adds, waits for the add to
//   complete, and bumps the counter with a release; f32 adds in a fixed
//   order give the same bits on every run (no atomicAdd whose order
//   varies).  Work items (kv tile, batch, kv head) go j-major to a
//   persistent grid of as many CTAs as fit on the card at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each CTA taking
//   items blockIdx.x + n gridDim.x in order: the lowest unfinished item's
//   CTA is running and waits on nothing unfinished, so every wait ends.
//   Causal tiles near the start carry the most work, so j-major is also
//   longest first.  A wait that does not end traps (a fault, not a hang).
//   With GQA (and some query row and key) an item is (kv tile, batch,
//   query head): a CTA over the whole group would leave 16 x 8 = 128 items
//   of unequal causal work for 132 SMs at llama3-8b's (2048, 32 on 8); each
//   item writes its dK and dV as f32 partials, which the finish kernel sums
//   over the group in head order.
//   Tiles: BC = 128 keys; BR = 128 query rows at D = 64, 64 at the
//   128-wide tile (S^T and dP^T are BR / 2 registers each a thread).  D =
//   80 runs the 128-wide tile, columns 80-127 zero-filled by TMA (S^T and
//   dP^T issue only the k-steps of real columns; dK, dV and dQ store only
//   columns below 80); D = 16 and 32 the 64-wide tile in the same way
//   (columns D-63 zero, their dQ sums zero and never stored).  Shared
//   memory 199,760 bytes (the 64-wide tile) and 215,120
//   (the 128-wide tile), one CTA an SM, 384 threads.  ptxas (sm_90a, CUDA
//   12.9, -O3): 168 registers at entry (the CTA's 64,512, which setmaxnreg
//   splits 24 / 240); spill stores of 60 bytes at D = 128, 44 at D = 80
//   and 96 at D = 64 (more with a 40 / 232 split: part of it is the
//   consumers').  Rows 16-byte aligned (TMA; the wrapper checks).
//   The proxy fences are scoped: .shared::cta after the consumers' stores
//   of dS^T and of the dQ partial, .global around the dQ warp's bulk add;
//   an unscoped fence.proxy.async made the whole pass markedly slower.
//   Tried on an H100 and dropped: two commit groups so that the
//   exponentials run under the next product (a few per cent at the
//   128-wide tile, slower at D = 64, where it spills more), S^T in two
//   halves of query rows (no faster), stmatrix for dS^T (no faster, more
//   spills), each warpgroup its own dQ over its own 64 keys with the
//   second adding the first's partial in shared memory, no named barriers
//   (slower, more spills).
// * f32: CUDA cores, three kernels, no atomics: delta; dK/dV, a block per
//   tile of keys over its group's heads and the query tiles; dQ, a block
//   per query tile recomputing S and dP (7 products); f32 products and
//   shared memory, expf (the 1e-4 tolerance of the f32 route rules out
//   bf16 operands).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr float NEG = -1e30f;  // the mask value of the JAX kernel

// the log-sum-exp of a row that sees no key
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------
namespace cc {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 32;        // keys per kv tile
constexpr int TX = 16;         // lanes sharing a query row
constexpr int TY = 16;         // row groups
constexpr int NTHREADS = TX * TY;
constexpr int RQ = BQ / TY;    // query rows per thread
constexpr int CK = BKV / TX;   // score columns per thread

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse, int Sq,
             int Skv, int group, Strides qs, Strides ks, Strides vs, Strides os, float scale,
             int causal) {
  constexpr int LD = D + 1;      // padded pitch of the Q and K tiles
  constexpr int PLD = BKV + 1;   // padded pitch of the P tile
  constexpr int CD = D / TX;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x LD
  float* Ks = Qs + BQ * LD;      // BKV x LD
  float* Vs = Ks + BKV * LD;     // BKV x D
  float* Ps = Vs + BKV * D;      // BQ x PLD

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? qb[qi * qs.s + d] : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  // causal: tiles starting after the last query row of this block are skipped
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BKV * D; i += NTHREADS) {
      const int c = i / D, d = i % D, kj = k0 + c;
      const bool ok = kj < Skv;
      Ks[c * LD + d] = ok ? kb[kj * ks.s + d] : 0.f;
      Vs[c * D + d] = ok ? vb[kj * vs.s + d] : 0.f;
    }
    __syncthreads();

    // scores: rows ty + TY*i, columns tx + TX*j of the tile
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax per row, reduced over the 16 lanes of the row group
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty + TY * i;
      bool ok[CK];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + TX * j;
        ok[j] = kj < Skv && (!causal || kj <= qi);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty + TY * i) * PLD + tx + TX * j] = p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = m_new;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty + TY*i, columns tx + TX*j of the (BQ, D) output
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + TY * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float vv = Vs[c * D + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < CD; ++j) orow[tx + TX * j] = acc[i][j] / denom;
    // the row's log-sum-exp of the scaled scores (natural log), -inf where
    // the row saw no key
    if (lse && tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : neg_inf();
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  dim3 block(TX, TY);
  flash_kernel<D><<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, Sq, Skv, Hq / Hkv, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma), TMA loads
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NWG = 2;                // warpgroups a block
constexpr int BQ = 64 * NWG;          // query rows a block, 64 a warpgroup
constexpr int BKV = 64;               // keys a K/V tile
constexpr int NTHREADS = 128 * NWG;
constexpr int NT = BKV / 8;           // 8-key n-tiles of a score row block

template <int DT>
constexpr int smem_bytes() {  // Q + 2 stages x (K, V) + 3 mbarriers + 1024-byte alignment
  return (BQ * DT + 2 * 2 * BKV * DT) * 2 + 3 * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (flushes a denormal result to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to nearest-even bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared-memory matrix descriptor of wgmma, 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" :: "r"(bar), "r"(phase) : "memory");
}
// one box of the 4-d tensor map (d, seq, head, batch) into shared memory,
// counted on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar) : "memory");
}

// d (64 x 64 f32, 8 n8 tiles x 4 a thread) (+)= A (64 x 16, K-major in shared
// memory) * B (16 x 64, K-major in shared memory); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32, 8 n8 tiles x 4 a thread) += A (64 x 16 bf16 in registers, the
// mma.m16n8k16 A fragment a warp) * B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32, 16 n8 tiles x 4 a thread) += A (64 x 16 bf16 in registers, the
// mma.m16n8k16 A fragment a warp) * B (16 x 128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Online softmax of one warp's 16 x BKV scores s (C fragments: s[j][0..1]
// row g, s[j][2..3] row g + 8, keys 8j + 2t + {0, 1}), rescaling acc; on
// return s holds p.  MASK tests each key against Skv and the causal mask.
template <bool MASK, int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&acc)[ND][4],
                                             float (&m)[2], float (&l)[2], int row0, int key0,
                                             int Skv, int causal, float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][2 * r + e] * scale_log2;
        if (MASK) {
          const int key = key0 + 8 * j + e;
          if (key >= Skv || (causal && key > row)) x = NEG;
        }
        s[j][2 * r + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    // a row that has seen no key yet: its max is NEG; subtract 0 instead, so
    // every masked p is exp2(-1e30) = 0 and the rescale of nothing is 0
    const float m_use = (MASK && m_new == NEG) ? 0.f : m_new;
    const float corr = fast_exp2(m[r] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(s[j][2 * r + e] - m_use);
        s[j][2 * r + e] = p;
        sum += p;
      }
    m[r] = m_new;
    l[r] = l[r] * corr + sum;  // this thread's partial row sum
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][2 * r] *= corr;
      acc[n][2 * r + 1] *= corr;
    }
  }
}

// Shared memory, 1024-byte aligned: Q as [DT / 64][BQ][64], then stage i's
// K and V as [DT / 64][BKV][64] each, rows of 128 bytes in TMA's 128-byte
// swizzle; then the mbarriers of Q and of the two stages.  DT is the tile
// width (64 or 128), D <= DT the head dim; columns D..DT-1 arrive as zeros.
template <int DT, int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                float* __restrict__ lse, int Sq, int Skv, int group, Strides os, float scale_log2,
                int causal) {
  static_assert(D % 16 == 0 && D <= DT, "a head dim of whole k-steps within the tile");
  constexpr int KD = DT / 16;  // k-steps of Q K^T over the tile
  constexpr int ND = DT / 8;   // 8-column n-tiles of the output tile
  constexpr int DB = DT / 64;  // 64-column boxes a row
  constexpr uint32_t QB = BQ * DT * 2, KB = BKV * DT * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + QB;        // stage i: K at sKV + 2 i KB, V KB after it
  const uint32_t bars = sKV + 4 * KB;  // mbarriers: Q, stage 0, stage 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  const int hk = h / group;
  // causal: kv tiles starting after the block's last query row are skipped
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int ntiles = (kv_end + BKV - 1) / BKV;

  auto load_kv = [&](int tile, int stage) {  // one thread
    const uint32_t sK = sKV + stage * 2 * KB, sV = sK + KB, bar = bars + 8 * (1 + stage);
    mbar_expect_tx(bar, 2 * KB);
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      tma_load(sK + db * BKV * 128, &tk, db * 64, tile * BKV, hk, b, bar);
      tma_load(sV + db * BKV * 128, &tv, db * 64, tile * BKV, hk, b, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, QB);
#pragma unroll
    for (int db = 0; db < DB; ++db) tma_load(sQ + db * BQ * 128, &tq, db * 64, q0, h, b, bars);
    if (ntiles > 0) load_kv(0, 0);
    if (ntiles > 1) load_kv(1, 1);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int wgi = warp >> 2;      // this thread's warpgroup
  const int qw0 = q0 + wgi * 64;  // and its first query row
  const int row0 = qw0 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int quad = lane & 3;
  if (ntiles > 0) mbar_wait(bars, 0);

  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(bars + 8 * (1 + (t & 1)), (t >> 1) & 1);
    const uint32_t sK = sKV + (t & 1) * 2 * KB, sV = sK + KB;
    const int k0 = t * BKV;
    if (!(causal && k0 > qw0 + 63)) {  // a tile wholly in this warpgroup's future: skipped
      // S = Q K^T, both operands K-major in shared memory; a k-step of 16
      // moves 32 bytes along the swizzled 128-byte rows
      float s[NT][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        if (kk * 16 < D)  // k-steps in the zero columns past D are not issued
          wgmma_ss_n64(s, desc(sQ + (kk >> 2) * (BQ * 128) + wgi * 64 * 128 + (kk & 3) * 32, 16,
                               1024),
                       desc(sK + (kk >> 2) * (BKV * 128) + (kk & 3) * 32, 16, 1024), kk > 0);
      wg_commit();
      wg_wait0();

      // only tiles crossing the diagonal or the end of Skv test the mask
      if (k0 + BKV > Skv || (causal && k0 + BKV - 1 > qw0))
        softmax_tile<true, ND>(s, acc, m, l, row0, k0 + 2 * quad, Skv, causal, scale_log2);
      else
        softmax_tile<false, ND>(s, acc, m, l, row0, k0 + 2 * quad, Skv, causal, scale_log2);

      // acc += P V: P's C fragments are the register A fragments as they
      // are; V is MN-major (64-column boxes LBO apart, 8-key groups SBO apart)
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t dv = desc(sV + kk * 16 * 128, BKV * 128, 1024);
        if constexpr (DT == 128) wgmma_rs_n128(acc, pa[kk], dv);
        else wgmma_rs_n64(acc, pa[kk], dv);
      }
      wg_commit();
      wg_wait0();
    }
    __syncthreads();  // every warp is done with stage t & 1: refill it with tile t + 2
    if (tid == 0 && t + 2 < ntiles) load_kv(t + 2, t & 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = out + b * os.b + qi * os.s + h * os.h + 2 * quad;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (8 * n < D)  // the tile's columns past D are not the output's
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    // m is the row max in the log2 domain: lse = ln 2 * (m + log2 l), -inf
    // where the row saw no key
    if (lse && quad == 0)
      lse[((long long)b * gridDim.x + h) * Sq + qi] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : neg_inf();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// (B, S, H, D) bf16 through element strides as the 4-d map (d, seq, head,
// batch) of 64 x rows boxes, 128-byte swizzle; rows past S, and columns
// past D of a box, read as zeros.
// cuTensorMapEncodeTiled is looked up through the runtime
// (cudaGetDriverEntryPoint), so nothing links libcuda.
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                     const Strides& st, int rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || !encode) {
      encode = nullptr;
      return cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  // byte strides of seq, head, batch; a unit dim's (given as 0) is never used
  cuuint64_t s1 = st.s * 2, s2 = st.h * 2, s3 = st.b * 2;
  if (s1 == 0) s1 = (cuuint64_t)D * 2;
  if (s2 == 0) s2 = s1 * S;
  if (s3 == 0) s3 = s2 * H;
  const cuuint64_t strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// DT: the tile width (64 for D = 16, 32 and 64, 128 for D = 80 and 128); D: the real head dim
template <int DT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DT>();
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, Sq, Hq, D, qs, BQ);
  if (err == cudaSuccess) err = make_map(&tk, k, B, Skv, Hkv, D, ks, BKV);
  if (err == cudaSuccess) err = make_map(&tv, v, B, Skv, Hkv, D, vs, BKV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_tc_kernel<DT, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, (Sq + BQ - 1) / BQ, B);
  flash_tc_kernel<DT, D><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, Sq, Skv, Hq / Hkv, os,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// backward (flash_attention_bwd): the f32 route on CUDA cores (delta,
// dK/dV, dQ), then the bf16 route's one pass on the tensor cores (one::)
// ---------------------------------------------------------------------------
namespace bw {

constexpr int TX = 16, TY = 16, NTHREADS = TX * TY;
constexpr int KV_BKV = 64, KV_BQ = 32;  // dK/dV: keys a block, query rows a step
constexpr int Q_BQ = 64, Q_BKV = 32;    // dQ: query rows a block, keys a step

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * KV_BKV * (D + 1) + 2 * KV_BQ * (D + 1) + 2 * KV_BQ * (KV_BKV + 1) + 2 * KV_BQ;
}
template <int D>
constexpr int dq_smem_floats() {
  return 2 * Q_BQ * (D + 1) + 2 * Q_BKV * (D + 1) + Q_BQ * (Q_BKV + 1) + 2 * Q_BQ;
}

// rows [r0, r0 + n) of one head of a (B, S, H, D) tensor (base: its batch
// and head already applied) into shared memory as f32 rows of pitch D + 1,
// zeros past S
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long ss, int r0,
                                          int n, int S) {
  for (int i = threadIdx.y * TX + threadIdx.x; i < n * D; i += NTHREADS) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? base[row * ss + d] : 0.f;
  }
}

// the lse and delta of rows [r0, r0 + n) of one (batch, head); a row past
// Sq gets lse -inf, so its p is 0
__device__ __forceinline__ void load_stats(float* Ls, float* Dl, const float* lse,
                                           const float* delta, int r0, int n, int Sq) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (tid < n) {
    const int row = r0 + tid;
    Ls[tid] = row < Sq ? lse[row] : neg_inf();
    Dl[tid] = row < Sq ? delta[row] : 0.f;
  }
}

// p = exp(scale s - lse) of a visible (query, key) pair, 0 otherwise (a key
// past Skv, a causal future key, a row with lse -inf: no NaN from -inf)
__device__ __forceinline__ float prob(float s, float L, int qi, int kj, int Skv, int causal,
                                      float scale) {
  const bool ok = kj < Skv && (!causal || kj <= qi) && L != neg_inf();
  return ok ? expf(s * scale - L) : 0.f;
}

// delta[b, h, s] = sum_d dO * O over one row a warp, f32
template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ delta,
             int B, int Hq, int Sq, Strides os, Strides dos) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;  // over (B, Hq, Sq)
  if (row >= (long long)B * Hq * Sq) return;
  const int s = (int)(row % Sq), h = (int)((row / Sq) % Hq), b = (int)(row / ((long long)Sq * Hq));
  const float* orow = o + b * os.b + s * os.s + h * os.h;
  const float* drow = dout + b * dos.b + s * dos.s + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// dK and dV of KV_BKV keys of one kv head: every query head of its group,
// every query tile from the causal start; sums in registers, no atomics
template <int D>
__global__ void __launch_bounds__(NTHREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Hq,
            int Sq, int Skv, int group, Strides qs, Strides ks, Strides vs, Strides dos,
            Strides dks, Strides dvs, float scale, int causal) {
  constexpr int LD = D + 1, PLD = KV_BKV + 1, CD = D / TX;
  constexpr int RK = KV_BKV / TY, RQ = KV_BQ / TY, CK = KV_BKV / TX;
  extern __shared__ float smem[];
  float* Ks = smem;               // KV_BKV x LD
  float* Vs = Ks + KV_BKV * LD;   // KV_BKV x LD
  float* Qs = Vs + KV_BKV * LD;   // KV_BQ x LD
  float* dOs = Qs + KV_BQ * LD;   // KV_BQ x LD
  float* Ps = dOs + KV_BQ * LD;   // KV_BQ x PLD
  float* dSs = Ps + KV_BQ * PLD;  // KV_BQ x PLD
  float* Ls = dSs + KV_BQ * PLD;  // KV_BQ
  float* Dl = Ls + KV_BQ;         // KV_BQ

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.x * KV_BKV, hk = blockIdx.y, b = blockIdx.z;
  load_rows<D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, KV_BKV, Skv);
  load_rows<D>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, KV_BKV, Skv);

  float dk_acc[RK][CD], dv_acc[RK][CD];  // keys ty + TY*a, columns tx + TX*c
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  // causal: query rows before k0 see none of these keys
  const int qstart = causal ? (k0 / KV_BQ) * KV_BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    const long long so = ((long long)b * Hq + h) * Sq;
    for (int q0 = qstart; q0 < Sq; q0 += KV_BQ) {
      __syncthreads();  // the previous step's Q, dO, P and dS are no longer read
      load_rows<D>(Qs, qb, qs.s, q0, KV_BQ, Sq);
      load_rows<D>(dOs, dob, dos.s, q0, KV_BQ, Sq);
      load_stats(Ls, Dl, lse + so, delta + so, q0, KV_BQ, Sq);
      __syncthreads();

      // S = Q K^float and dP = dO V^float: rows ty + TY*a, keys tx + TX*c of the tile
      float s[RQ][CK], dp[RQ][CK];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
        for (int a = 0; a < RQ; ++a) {
          qv[a] = Qs[(ty + TY * a) * LD + d];
          ov[a] = dOs[(ty + TY * a) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          kv[c] = Ks[(tx + TX * c) * LD + d];
          vv[c] = Vs[(tx + TX * c) * LD + d];
        }
#pragma unroll
        for (int a = 0; a < RQ; ++a)
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
            dp[a][c] = fmaf(ov[a], vv[c], dp[a][c]);
          }
      }
      // P and dS = P (dP - delta)
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int i = ty + TY * a;
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const int j = tx + TX * c;
          const float p = prob(s[a][c], Ls[i], q0 + i, k0 + j, Skv, causal, scale);
          Ps[i * PLD + j] = p;
          dSs[i * PLD + j] = p * (dp[a][c] - Dl[i]);
        }
      }
      __syncthreads();

      // dV += P^float dO, dK += dS^float Q: keys ty + TY*a, columns tx + TX*c
#pragma unroll 4
      for (int i = 0; i < KV_BQ; ++i) {
        float pv[RK], sv[RK];
#pragma unroll
        for (int a = 0; a < RK; ++a) {
          pv[a] = Ps[i * PLD + ty + TY * a];
          sv[a] = dSs[i * PLD + ty + TY * a];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const float ov = dOs[i * LD + tx + TX * c], qv = Qs[i * LD + tx + TX * c];
#pragma unroll
          for (int a = 0; a < RK; ++a) {
            dv_acc[a][c] = fmaf(pv[a], ov, dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sv[a], qv, dk_acc[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RK; ++a) {
    const int kj = k0 + ty + TY * a;
    if (kj >= Skv) continue;
    float* dkrow = dk + b * dks.b + kj * dks.s + hk * dks.h;
    float* dvrow = dv + b * dvs.b + kj * dvs.s + hk * dvs.h;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dkrow[tx + TX * c] = dk_acc[a][c] * scale;
      dvrow[tx + TX * c] = dv_acc[a][c];
    }
  }
}

// dQ of Q_BQ query rows of one query head, over the kv tiles up to the
// causal end; recomputes P and dP (two more products than one pass with
// atomics would, for a result that is bitwise repeatable)
template <int D>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int Hq, int Sq, int Skv, int group,
          Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale, int causal) {
  constexpr int LD = D + 1, SLD = Q_BKV + 1, CD = D / TX;
  constexpr int RQ = Q_BQ / TY, CK = Q_BKV / TX;
  extern __shared__ float smem[];
  float* Qs = smem;               // Q_BQ x LD
  float* dOs = Qs + Q_BQ * LD;    // Q_BQ x LD
  float* Ks = dOs + Q_BQ * LD;    // Q_BKV x LD
  float* Vs = Ks + Q_BKV * LD;    // Q_BKV x LD
  float* dSs = Vs + Q_BKV * LD;   // Q_BQ x SLD
  float* Ls = dSs + Q_BQ * SLD;   // Q_BQ
  float* Dl = Ls + Q_BQ;          // Q_BQ

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int q0 = blockIdx.x * Q_BQ, h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const long long so = ((long long)b * Hq + h) * Sq;
  load_rows<D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Q_BQ, Sq);
  load_rows<D>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, Q_BQ, Sq);
  load_stats(Ls, Dl, lse + so, delta + so, q0, Q_BQ, Sq);
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  float acc[RQ][CD];  // rows ty + TY*a, columns tx + TX*c
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[a][c] = 0.f;

  const int kv_end = causal ? min(Skv, q0 + Q_BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += Q_BKV) {
    __syncthreads();  // Q, dO and the stats are in; the previous K, V, dS no longer read
    load_rows<D>(Ks, kb, ks.s, k0, Q_BKV, Skv);
    load_rows<D>(Vs, vb, vs.s, k0, Q_BKV, Skv);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        qv[a] = Qs[(ty + TY * a) * LD + d];
        ov[a] = dOs[(ty + TY * a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        kv[c] = Ks[(tx + TX * c) * LD + d];
        vv[c] = Vs[(tx + TX * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
          dp[a][c] = fmaf(ov[a], vv[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + TY * a;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int j = tx + TX * c;
        const float p = prob(s[a][c], Ls[i], q0 + i, k0 + j, Skv, causal, scale);
        dSs[i * SLD + j] = p * (dp[a][c] - Dl[i]);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < Q_BKV; ++j) {
      float sv[RQ];
#pragma unroll
      for (int a = 0; a < RQ; ++a) sv[a] = dSs[(ty + TY * a) * SLD + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float kv = Ks[j * LD + tx + TX * c];
#pragma unroll
        for (int a = 0; a < RQ; ++a) acc[a][c] = fmaf(sv[a], kv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int qi = q0 + ty + TY * a;
    if (qi >= Sq) continue;
    float* row = dq + b * dqs.b + qi * dqs.s + h * dqs.h;
#pragma unroll
    for (int c = 0; c < CD; ++c) row[tx + TX * c] = acc[a][c] * scale;
  }
}

// the f32 route's three launches: delta, dK/dV, dQ (each skipped where its
// grid is empty)
template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* o,
                       const float* dout, const float* lse, float* delta, float* dq, float* dk,
                       float* dv, int B, int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
                       Strides vs, Strides os, Strides dos, Strides dqs, Strides dks, Strides dvs,
                       float scale, int causal, cudaStream_t st, int* launched) {
  const long long rows = (long long)B * Hq * Sq;
  if (rows > 0) {
    delta_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, delta, B, Hq, Sq,
                                                                       os, dos);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (Skv > 0) {
    constexpr int smem = dkdv_smem_floats<D>() * 4;
    cudaError_t err =
        cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dkdv_kernel<D><<<dim3((Skv + KV_BKV - 1) / KV_BKV, Hkv, B), dim3(TX, TY), smem, st>>>(
        q, k, v, dout, lse, delta, dk, dv, Hq, Sq, Skv, Hq / Hkv, qs, ks, vs, dos, dks, dvs,
        scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (Sq > 0) {
    constexpr int smem = dq_smem_floats<D>() * 4;
    cudaError_t err =
        cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dq_kernel<D><<<dim3((Sq + Q_BQ - 1) / Q_BQ, Hq, B), dim3(TX, TY), smem, st>>>(
        q, k, v, dout, lse, delta, dq, Hq, Sq, Skv, Hq / Hkv, qs, ks, vs, dos, dqs, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

// ---- the bf16 route: one pass on the tensor cores (wgmma, TMA) ----
//
// A CTA owns BC = 128 keys of one kv head (64 for each of two consumer
// warpgroups, wgmma's M) and walks its group's query heads and the query
// tiles of BR rows from the causal start.  A producer warpgroup feeds it:
// one warp keeps TMA loads in flight, one adds the dQ partials into an f32
// scratch in a fixed order.  See the file's header.
namespace one {

using bf16 = __nv_bfloat16;
constexpr int BC = 128;         // keys a CTA, 64 a consumer warpgroup
constexpr int NTHREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t SPIN_LIMIT = 1u << 23;  // polls before a wait traps (a fault, not a hang)

// the query rows a tile: 128 at D = 64, 64 at the 128-wide tile (registers)
template <int DT>
__host__ __device__ constexpr int rows() { return DT == 64 ? 128 : 64; }

// shared-memory byte offsets from the 1024-aligned base: K and V as DT / 64
// boxes of [BC][64], two stages of Q and dO as boxes of [BR][64] (all in
// TMA's 128-byte swizzle), dS^T as BR / 64 boxes of [BC][64] (the same
// swizzle, written by the consumers), two dQ partials of BR x DT f32, the
// stages' lse2 and delta rows, then the mbarriers
template <int DT>
struct Layout {
  static constexpr int BR = rows<DT>();
  static constexpr int KB = BC * DT * 2, QB = BR * DT * 2, DQF = BR * DT;
  static constexpr int K = 0, V = KB, STAGE = 2 * KB;  // stage s: Q at STAGE + 2 s QB, dO after
  static constexpr int DS = STAGE + 4 * QB;
  static constexpr int DQ = DS + BC * BR * 2;          // buffer b at DQ + 4 b DQF
  static constexpr int STATS = DQ + 8 * DQF;           // stage s: lse2 at STATS + 8 s BR, delta after
  static constexpr int BARS = STATS + 16 * BR;
  // full[2], empty[2], kv_full, kv_empty, dq_full[2], dq_empty[2]
  static constexpr int FULL = BARS, EMPTY = BARS + 16, KV_FULL = BARS + 32, KV_EMPTY = BARS + 40,
                       DQ_FULL = BARS + 48, DQ_EMPTY = BARS + 64;
  static constexpr int BYTES = BARS + 80 + 1024;  // + the alignment of the base
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// wait for the phase of parity `phase` to complete; trap instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    if (done) return;
    if (n > SPIN_LIMIT) __trap();
  }
}
__device__ __forceinline__ void bar_sync(int id) {  // the 256 consumer threads
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
// order this thread's generic-proxy writes to shared memory before the
// async proxy's reads (a wgmma, a bulk copy), or its global accesses with
// the async proxy's
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// a 1-d bulk copy of `bytes` (a multiple of 16) from global into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// global[0 .. bytes) += shared[0 .. bytes), f32 elementwise, in L2; waited for
// to completion (the writes done) before it returns
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// d (64 x 64 f32) (+)= A (64 x 16) * B (16 x 64), both in shared memory;
// TA / TB: 0 K-major, 1 MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 128 f32) (+)= A (64 x 16) * B (16 x 128), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S^T or dP^T over N query rows, both operands K-major
template <int N>
__device__ __forceinline__ void wgmma_ss_k(float (&d)[N / 8][4], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, scale_d);
  else wgmma_ss_n64<0, 0>(d, da, db, scale_d);
}
template <int DT>
__device__ __forceinline__ void wgmma_rs(float (&d)[DT / 8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DT == 128) tc::wgmma_rs_n128(d, a, db);
  else tc::wgmma_rs_n64(d, a, db);
}

// C fragments of 2 KS n-tiles (f32) as the register A fragments of a
// product over those columns, rounded to bf16 (C and A share a layout)
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4], const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = tc::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = tc::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = tc::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = tc::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// The work a CTA walks, in the same order in each of its roles: items
// (kv tile j, batch, kv head) j-major, blockIdx.x + n gridDim.x; in an
// item its group's query heads and the query tiles from the causal start.
// split (GQA): an item is (kv tile, batch, query head) instead, so that
// causal kv tiles of unequal work spread over the grid; its dK and dV are
// f32 partials that the finish kernel sums over the group in a fixed order.
struct Work {
  int B, Hq, Hkv, Sq, Skv, nqt, causal, split;
  __device__ int heads() const { return split ? Hq : Hkv; }  // item heads a batch
  __device__ int items() const { return ((Skv + BC - 1) / BC) * B * heads(); }
  // item it: kv tile j, batch b, kv head hk, its first query head h0 and count ng
  __device__ void item(int it, int& j, int& b, int& hk, int& h0, int& ng) const {
    const int nh = heads(), group = Hq / Hkv, hi = it % nh;
    j = it / (B * nh);
    b = (it / nh) % B;
    hk = split ? hi / group : hi;
    h0 = split ? hi : hk * group;
    ng = split ? 1 : group;
  }
};

// Pre-pass: per row of the padded (B, Hq, Sq_pad) rows, delta = rowsum(dO
// * O) and lse2 = lse * log2(e) (+inf for a row past Sq or one that saw no
// key, so its p is exp2(-inf) = 0), delta 0 past Sq; the row's DT floats of
// dq_accum zeroed; the first row of a query tile zeroes the tile's counter.
template <int DT, int D>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
            int* __restrict__ counters, float* __restrict__ dq_accum, int B, int Hq, int Sq,
            int Sq_pad, Strides os, Strides dos) {
  constexpr int BR = rows<DT>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;  // over (B, Hq, Sq_pad)
  if (row >= (long long)B * Hq * Sq_pad) return;
  const int s = (int)(row % Sq_pad);
  const long long bh = row / Sq_pad;
  float acc = 0.f;
  if (s < Sq) {
    const int h = (int)(bh % Hq), b = (int)(bh / Hq);
    const bf16* orow = o + b * os.b + s * os.s + h * os.h;
    const bf16* drow = dout + b * dos.b + s * dos.s + h * dos.h;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(__bfloat162float(orow[d]), __bfloat162float(drow[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  float* z = dq_accum + row * DT;
  for (int d = 2 * lane; d < DT; d += 64) *reinterpret_cast<float2*>(z + d) = make_float2(0.f, 0.f);
  if (lane == 0) {
    const float l = s < Sq ? lse[bh * Sq + s] : neg_inf();
    lse2[row] = l == neg_inf() ? __int_as_float(0x7f800000) : l * LOG2E;
    delta[row] = acc;
    if (s % BR == 0) counters[row / BR] = 0;
  }
}

// Finish: dq = bf16(scale * dq_accum), one CTA a (batch, head, query tile);
// dq_accum holds a tile in the consumers' fragment order (see bwd_tc_kernel).
// With split items, the CTAs after those sum each dK and dV column pair
// over the group's query heads in head order, f32, into bf16.
template <int DT>
__global__ void __launch_bounds__(256)
bwd_finish_kernel(const float* __restrict__ dq_accum, bf16* __restrict__ dq, int B, int Hq,
                  int Hkv, int Sq, int Skv, int D, int nqt, Strides dqs, float scale,
                  const float* __restrict__ dkv, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  Strides dks, Strides dvs) {
  constexpr int BR = rows<DT>();
  const long long tiles = (long long)B * Hq * nqt;
  if (blockIdx.x >= tiles) {
    const long long pair = (blockIdx.x - tiles) * blockDim.x + threadIdx.x;
    const int half = D / 2;
    if (pair >= (long long)B * Hkv * Skv * half) return;
    const int col = 2 * (int)(pair % half), key = (int)((pair / half) % Skv);
    const int hk = (int)((pair / half / Skv) % Hkv), b = (int)(pair / half / Skv / Hkv);
    const int group = Hq / Hkv, skv_pad = (Skv + BC - 1) / BC * BC;
    const long long part = (long long)B * Hq * skv_pad * DT;  // dK's partials, then dV's
    float2 sk = make_float2(0.f, 0.f), sv = sk;
    for (int g = 0; g < group; ++g) {
      const long long at = (((long long)b * Hq + hk * group + g) * skv_pad + key) * DT + col;
      const float2 pk = *reinterpret_cast<const float2*>(dkv + at);
      const float2 pv = *reinterpret_cast<const float2*>(dkv + part + at);
      sk.x += pk.x, sk.y += pk.y, sv.x += pv.x, sv.y += pv.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(dk + b * dks.b + key * dks.s + hk * dks.h + col) =
        __floats2bfloat162_rn(sk.x, sk.y);
    *reinterpret_cast<__nv_bfloat162*>(dv + b * dvs.b + key * dvs.s + hk * dvs.h + col) =
        __floats2bfloat162_rn(sv.x, sv.y);
    return;
  }
  const long long tile = blockIdx.x;
  const int i = (int)(tile % nqt), h = (int)((tile / nqt) % Hq), b = (int)(tile / nqt / Hq);
  const float4* src = reinterpret_cast<const float4*>(dq_accum + tile * (BR * DT));
  for (int f = threadIdx.x; f < BR * DT / 4; f += blockDim.x) {
    const int lane = f & 31, n = (f >> 5) & 7, wi = (f >> 8) & 3, w = f >> 10;
    const int row = (BR == 128 ? 64 * w : 0) + 16 * wi + (lane >> 2);
    const int col = (DT == 128 ? 64 * w : 0) + 8 * n + 2 * (lane & 3);
    if (col >= D) continue;
    const float4 v = src[f];
    const int q = i * BR + row;
    bf16* out = dq + b * dqs.b + h * dqs.h + col;
    if (q < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + q * dqs.s) =
          __floats2bfloat162_rn(v.x * scale, v.y * scale);
    if (q + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (q + 8) * dqs.s) =
          __floats2bfloat162_rn(v.z * scale, v.w * scale);
  }
}

// The one pass.  Consumer warpgroup w (warps 4w .. 4w + 3) owns keys k0 +
// 64 w .. + 63; warp 8 loads, warp 9 adds dQ; warps 10 and 11 only give
// their registers back.
template <int DT, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse2, const float* __restrict__ delta,
            int* __restrict__ counters, float* __restrict__ dq_accum, bf16* __restrict__ dk,
            bf16* __restrict__ dv, float* __restrict__ dkv, Work wk, Strides dks, Strides dvs,
            float scale) {
  using L = Layout<DT>;
  constexpr int BR = L::BR;
  constexpr int KD = DT / 16;  // k-steps of S^T and dP^T over the tile width
  constexpr int NS = BR / 8;   // 8-column n-tiles of S^T (query rows)
  constexpr int ND = DT / 8;   // n-tiles of dK and dV
  constexpr int KS = BR / 16;  // k-steps of dK and dV (query rows)
  constexpr int DB = DT / 64;  // 64-column boxes a row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  const uint32_t sb = raw + pad;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_items = wk.items();
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      tc::mbar_init(sb + L::FULL + 8 * s, 1);
      tc::mbar_init(sb + L::EMPTY + 8 * s, 8);
      tc::mbar_init(sb + L::DQ_FULL + 8 * s, 8);
      tc::mbar_init(sb + L::DQ_EMPTY + 8 * s, 1);
    }
    tc::mbar_init(sb + L::KV_FULL, 1);
    tc::mbar_init(sb + L::KV_EMPTY, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // ---------------- producer warpgroup ----------------
    // 128 x 24 + 256 x 240 registers: the 168 x 384 the CTA starts with
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (lane != 0 || warp > 9) return;
    int T = 0, I = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++I) {
      int j, b, hk, h0, ng;
      wk.item(it, j, b, hk, h0, ng);
      const int k0 = j * BC, i0 = wk.causal ? k0 / BR : 0;
      if (warp == 8) {  // loads
        mbar_wait(sb + L::KV_EMPTY, (I & 1) ^ 1);
        tc::mbar_expect_tx(sb + L::KV_FULL, 2 * L::KB);
#pragma unroll
        for (int db = 0; db < DB; ++db) {
          tc::tma_load(sb + L::K + db * BC * 128, &tk, db * 64, k0, hk, b, sb + L::KV_FULL);
          tc::tma_load(sb + L::V + db * BC * 128, &tv, db * 64, k0, hk, b, sb + L::KV_FULL);
        }
      }
      for (int h = h0; h < h0 + ng; ++h) {
        const long long bh = (long long)b * wk.Hq + h;
        for (int i = i0; i < wk.nqt; ++i, ++T) {
          const int st = T & 1;
          const uint32_t ph = (T >> 1) & 1;
          if (warp == 8) {
            const uint32_t full = sb + L::FULL + 8 * st, sQ = sb + L::STAGE + 2 * st * L::QB;
            mbar_wait(sb + L::EMPTY + 8 * st, ph ^ 1);
            tc::mbar_expect_tx(full, 2 * L::QB + 8 * BR);
#pragma unroll
            for (int db = 0; db < DB; ++db) {
              tc::tma_load(sQ + db * BR * 128, &tq, db * 64, i * BR, h, b, full);
              tc::tma_load(sQ + L::QB + db * BR * 128, &tdo, db * 64, i * BR, h, b, full);
            }
            const long long r0 = (bh * wk.nqt + i) * BR;
            bulk_load(sb + L::STATS + 8 * st * BR, lse2 + r0, 4 * BR, full);
            bulk_load(sb + L::STATS + 8 * st * BR + 4 * BR, delta + r0, 4 * BR, full);
          } else {  // the ordered dQ sum: kv tile j adds after tiles 0 .. j - 1
            mbar_wait(sb + L::DQ_FULL + 8 * st, ph);
            const long long t = bh * wk.nqt + i;
            for (uint32_t n = 0; ld_acquire(counters + t) != j; ++n)
              if (n > SPIN_LIMIT) __trap();
            fence_async_global();
            bulk_reduce_add(dq_accum + t * L::DQF, sb + L::DQ + 4 * st * L::DQF, 4 * L::DQF);
            fence_async_global();
            red_release_add(counters + t, 1);
            mbar_arrive(sb + L::DQ_EMPTY + 8 * st);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = warp >> 2, wi = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * LOG2E;
  const uint32_t sK = sb + L::K, sV = sb + L::V, sDS = sb + L::DS;
  int T = 0, I = 0;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++I) {
    int j, b, hk, h0, ng;
    wk.item(it, j, b, hk, h0, ng);
    const int k0 = j * BC, i0 = wk.causal ? k0 / BR : 0;
    const int kw = k0 + 64 * w;  // this warpgroup's first key
    float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
    mbar_wait(sb + L::KV_FULL, I & 1);

    for (int g = 0; g < ng; ++g) {
      for (int i = i0; i < wk.nqt; ++i, ++T) {
        const int st = T & 1, q0 = i * BR;
        const uint32_t ph = (T >> 1) & 1;
        const uint32_t sQ = sb + L::STAGE + 2 * st * L::QB, sdO = sQ + L::QB;
        const float* lse2s = reinterpret_cast<const float*>(base + L::STATS + 8 * st * BR);
        const float* dels = lse2s + BR;
        mbar_wait(sb + L::FULL + 8 * st, ph);

        // S^T = K Q^T and dP^T = V dO^T: rows this warpgroup's keys, columns
        // the tile's query rows, all operands K-major (a k-step of 16 moves
        // 32 bytes along the swizzled 128-byte rows)
        float s[NS][4], dp[NS][4];
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          if (kk * 16 < D) {  // k-steps in the zero columns past D are not issued
            const uint32_t ka = (kk >> 2) * (BC * 128) + 64 * w * 128 + (kk & 3) * 32;
            const uint32_t qb = (kk >> 2) * (BR * 128) + (kk & 3) * 32;
            wgmma_ss_k<BR>(s, tc::desc(sK + ka, 16, 1024), tc::desc(sQ + qb, 16, 1024), kk > 0);
            wgmma_ss_k<BR>(dp, tc::desc(sV + ka, 16, 1024), tc::desc(sdO + qb, 16, 1024), kk > 0);
          }
        tc::wg_commit();
        tc::wg_wait0();

        // P^T = exp2(scale log2(e) S^T - lse2), dS^T = P^T (dP^T - delta): a
        // thread's rows are keys kw + 16 wi + g8 (+ 8), its columns query rows
        // q0 + 8 n + 2 t4 (+ 1); only tiles crossing the end of Skv or the
        // diagonal test the mask (a row past Sq has lse2 +inf: p = 0)
        const bool mask = kw + 63 >= wk.Skv || (wk.causal && kw + 63 > q0);
        const int key0 = kw + 16 * wi + g8;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse2s + 8 * n + 2 * t4);
          const float2 dl = *reinterpret_cast<const float2*>(dels + 8 * n + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = tc::fast_exp2(s[n][e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
            if (mask) {
              const int key = key0 + 8 * (e >> 1), q = q0 + 8 * n + 2 * t4 + (e & 1);
              if (key >= wk.Skv || (wk.causal && key > q)) p = 0.f;
            }
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - ((e & 1) ? dl.y : dl.x));
          }
        }
        uint32_t pa[KS][4], da[KS][4];
        to_a<KS>(pa, s);
        to_a<KS>(da, dp);

        // dV += P^T dO and dK += dS^T Q: A in registers, B MN-major
        // (64-column boxes BR * 128 bytes apart, 8-row groups 1024 apart)
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          wgmma_rs<DT>(dv_acc, pa[kk], tc::desc(sdO + kk * 16 * 128, BR * 128, 1024));
          wgmma_rs<DT>(dk_acc, da[kk], tc::desc(sQ + kk * 16 * 128, BR * 128, 1024));
        }
        tc::wg_commit();

        // dS^T into shared memory as bf16 rows of 64 query rows (128 bytes)
        // a key, in TMA's 128-byte swizzle: 16-byte chunk c of row r at
        // chunk c ^ (r % 8).  First both warpgroups are done reading the
        // previous tile's.
        bar_sync(1);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int ql = 16 * kk + 8 * (x >> 1) + 2 * t4;  // query row in the tile
            const int kl = 64 * w + 16 * wi + g8 + 8 * (x & 1);  // key in the CTA's tile
            const uint32_t addr = sDS + (ql >> 6) * (BC * 128) + kl * 128 +
                                  ((((ql & 63) >> 3) ^ (kl & 7)) << 4) + (ql & 7) * 2;
            asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(da[kk][x]) : "memory");
          }
        fence_async_shared();
        bar_sync(2);

        // this warpgroup's part of the partial dQ = dS K over the CTA's 128
        // keys: at D = 64 query rows 64 w .. + 63, else columns 64 w .. + 63;
        // A = dS (dS^T read MN-major), B = K (MN-major)
        float dq[8][4];
        const uint32_t abox = (BR == 128 ? w : 0) * (BC * 128);
        const uint32_t bbox = (DT == 128 ? w : 0) * (BC * 128);
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
          wgmma_ss_n64<1, 1>(dq, tc::desc(sDS + abox + kk * 16 * 128, BC * 128, 1024),
                             tc::desc(sK + bbox + kk * 16 * 128, BC * 128, 1024), kk > 0);
        tc::wg_commit();
        tc::wg_wait0();  // dV, dK and dQ: the stage and dS^T are no longer read
        __syncwarp();
        if (lane == 0) mbar_arrive(sb + L::EMPTY + 8 * st);

        // the partial into dQ buffer T & 1 in fragment order: float4 (((w * 4
        // + wi) * 8 + n) * 32 + lane), conflict-free; the dQ warp adds it
        mbar_wait(sb + L::DQ_EMPTY + 8 * st, ph ^ 1);
        float4* dst = reinterpret_cast<float4*>(base + L::DQ + 4 * st * L::DQF) +
                      (w * 4 + wi) * 8 * 32 + lane;
#pragma unroll
        for (int n = 0; n < 8; ++n) dst[n * 32] = make_float4(dq[n][0], dq[n][1], dq[n][2], dq[n][3]);
        fence_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(sb + L::DQ_FULL + 8 * st);
      }
    }

    // dK = scale dS^T Q and dV of this thread's keys kw + 16 wi + g8 (+ 8):
    // bf16 into dk and dv, or with split items f32 partials of query head
    // h0 into dkv (dK's (B, Hq, Skv_pad, DT), then dV's)
    const int skv_pad = (wk.Skv + BC - 1) / BC * BC;
    const long long part = (long long)wk.B * wk.Hq * skv_pad * DT;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + 16 * wi + g8 + 8 * r;
      if (key >= wk.Skv) continue;
      bf16* dkrow = dk + b * dks.b + key * dks.s + hk * dks.h + 2 * t4;
      bf16* dvrow = dv + b * dvs.b + key * dvs.s + hk * dvs.h + 2 * t4;
      float* prow = dkv + (((long long)b * wk.Hq + h0) * skv_pad + key) * DT + 2 * t4;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        if (8 * n < D) {
          const float2 vk = make_float2(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
          const float2 vv = make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
          if (wk.split) {
            *reinterpret_cast<float2*>(prow + 8 * n) = vk;
            *reinterpret_cast<float2*>(prow + part + 8 * n) = vv;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * n) = __floats2bfloat162_rn(vk.x, vk.y);
            *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * n) = __floats2bfloat162_rn(vv.x, vv.y);
          }
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sb + L::KV_EMPTY);  // K and V no longer read
  }
}

struct Workspace {
  long long lse2, delta, counters, dq_accum, dkv, bytes;
  bool split;
};
inline long long up256(long long x) { return (x + 255) / 256 * 256; }
inline int tile_width(int D) { return D <= 64 ? 64 : 128; }
// the workspace: lse2 and delta (B, Hq, Sq_pad) f32, a counter per (batch,
// head, query tile), dq_accum (B, Hq, Sq_pad, DT) f32, and with split items
// (GQA, some query row and key) dK's and dV's partials (B, Hq, Skv_pad, DT)
// f32, each 256-byte aligned
inline Workspace workspace(int B, int Hq, int Hkv, int Sq, int Skv, int D) {
  const int DT = tile_width(D), BR = DT == 64 ? rows<64>() : rows<128>();
  const long long pad_rows = (long long)B * Hq * ((Sq + BR - 1) / BR * BR);
  Workspace w;
  w.split = Hq != Hkv && Sq > 0 && Skv > 0;
  w.lse2 = 0;
  w.delta = up256(pad_rows * 4);
  w.counters = w.delta + up256(pad_rows * 4);
  w.dq_accum = w.counters + up256(pad_rows / BR * 4);
  w.dkv = w.dq_accum + up256(pad_rows * DT * 4);
  const long long skv_pad = (long long)(Skv + BC - 1) / BC * BC;
  w.bytes = w.dkv + (w.split ? 2 * (long long)B * Hq * skv_pad * DT * 4 : 0);
  return w;
}

template <int DT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* work, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                   Strides dos, Strides dqs, Strides dks, Strides dvs, float scale, int causal,
                   cudaStream_t st, int* launched) {
  constexpr int BR = rows<DT>();
  const int nqt = (Sq + BR - 1) / BR, Sq_pad = nqt * BR;
  const Workspace ws = workspace(B, Hq, Hkv, Sq, Skv, D);
  unsigned char* wb = static_cast<unsigned char*>(work);
  float* lse2 = reinterpret_cast<float*>(wb + ws.lse2);
  float* delta = reinterpret_cast<float*>(wb + ws.delta);
  int* counters = reinterpret_cast<int*>(wb + ws.counters);
  float* dq_accum = reinterpret_cast<float*>(wb + ws.dq_accum);
  float* dkv = reinterpret_cast<float*>(wb + ws.dkv);
  const long long rows_pad = (long long)B * Hq * Sq_pad;
  if (rows_pad > 0) {
    bwd_prep_kernel<DT, D><<<(unsigned)((rows_pad + 7) / 8), 256, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse2, delta, counters,
        dq_accum, B, Hq, Sq, Sq_pad, os, dos);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (Skv > 0) {
    constexpr int smem = Layout<DT>::BYTES;
    auto kernel = bwd_tc_kernel<DT, D>;
    CUtensorMap tq{}, tk, tv, tdo{};  // with Sq = 0 the query maps are never read
    cudaError_t err = tc::make_map(&tk, k, B, Skv, Hkv, D, ks, BC);
    if (err == cudaSuccess) err = tc::make_map(&tv, v, B, Skv, Hkv, D, vs, BC);
    if (err == cudaSuccess && Sq > 0) err = tc::make_map(&tq, q, B, Sq, Hq, D, qs, BR);
    if (err == cudaSuccess && Sq > 0) err = tc::make_map(&tdo, dout, B, Sq, Hq, D, dos, BR);
    // a persistent grid of CTAs that are all resident at once, so that the
    // ordered dQ sum's waits always point at a running CTA; the shared
    // memory attribute and the CTAs that fit are set up once a device
    static int cap_dev = -1, cap = 0;
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev != cap_dev) {
      int sms = 0, per_sm = 0;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
      if (err == cudaSuccess) cap_dev = dev, cap = per_sm * sms;
    }
    if (err != cudaSuccess) return err;
    if (cap < 1) return cudaErrorInvalidConfiguration;
    const Work wk{B, Hq, Hkv, Sq, Skv, nqt, causal, ws.split};
    const long long items = (long long)((Skv + BC - 1) / BC) * B * (ws.split ? Hq : Hkv);
    const int grid = (int)(items < cap ? items : cap);
    kernel<<<grid, NTHREADS, smem, st>>>(tq, tk, tv, tdo, lse2, delta, counters, dq_accum,
                                         static_cast<bf16*>(dk), static_cast<bf16*>(dv), dkv, wk,
                                         dks, dvs, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (Sq > 0) {
    // dq's tiles, then with split items 256 (dK, dV) column pairs a CTA
    const long long pairs = ws.split ? (long long)B * Hkv * Skv * (D / 2) : 0;
    bwd_finish_kernel<DT><<<(unsigned)((long long)B * Hq * nqt + (pairs + 255) / 256), 256, 0,
                            st>>>(
        dq_accum, static_cast<bf16*>(dq), B, Hq, Hkv, Sq, Skv, D, nqt, dqs, scale, dkv,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), dks, dvs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace one

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* work, void* dq, void* dk, void* dv,
                     int B, int Hq, int Hkv, int Sq, int Skv, const Strides (&s)[8], float scale,
                     int causal, cudaStream_t st, int* launched) {
  if constexpr (sizeof(T) == 4) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(o),
                *fdo = static_cast<const float*>(dout);
    float *fdq = static_cast<float*>(dq), *fdk = static_cast<float*>(dk),
          *fdv = static_cast<float*>(dv), *delta = static_cast<float*>(work);
#define BW_F32(DD)                                                                           \
  launch_f32<DD>(fq, fk, fv, fo, fdo, lse, delta, fdq, fdk, fdv, B, Hq, Hkv, Sq, Skv, s[0], \
                 s[1], s[2], s[3], s[4], s[5], s[6], s[7], scale, causal, st, launched)
    if (D == 16) return BW_F32(16);
    if (D == 32) return BW_F32(32);
    if (D == 64) return BW_F32(64);
    if (D == 80) return BW_F32(80);
    if (D == 128) return BW_F32(128);
#undef BW_F32
  } else {
#define BW_TC(DT, DD)                                                                          \
  one::launch<DT, DD>(q, k, v, o, dout, lse, work, dq, dk, dv, B, Hq, Hkv, Sq, Skv, s[0], s[1], \
                      s[2], s[3], s[4], s[5], s[6], s[7], scale, causal, st, launched)
    if (D == 16) return BW_TC(64, 16);  // the 64-wide tile, zero-filled past D
    if (D == 32) return BW_TC(64, 32);
    if (D == 64) return BW_TC(64, 64);
    if (D == 80) return BW_TC(128, 80);  // the 128-wide tile, zero-filled past D
    if (D == 128) return BW_TC(128, 128);
#undef BW_TC
  }
  return cudaErrorInvalidValue;
}
}  // namespace bw

bool rows_aligned(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (s.b % 8 == 0) && (s.s % 8 == 0) &&
         (s.h % 8 == 0);
}

}  // namespace

extern "C" {

// out (B, Sq, Hq, D) = attention of q (B, Sq, Hq, D) over k, v (B, Skv, Hkv, D),
// every tensor addressed as base + b*sb + s*ss + h*sh + d (element strides,
// d contiguous; a unit dim's stride may be given as 0).  D is 16, 32, 64, 80 or 128; Hq
// a multiple of Hkv; Sq / 128 and B <= 65535.  f32 runs on the CUDA cores,
// bf16 on the tensor cores, with every row 16-byte aligned.
int flash_attention(const void* q, const void* k, const void* v, void* out, void* lse_out,
                    int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D, long long qsb,
                    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh, long long osb, long long oss,
                    long long osh, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  if (dtype == F32) {
    if (D == 16) return (int)cc::launch<16>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 32) return (int)cc::launch<32>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 64) return (int)cc::launch<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 80) return (int)cc::launch<80>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 128) return (int)cc::launch<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  if (Skv <= 0) return (int)cudaErrorInvalidValue;  // a tensor map needs a row
  if (!(rows_aligned(q, qs) && rows_aligned(k, ks) && rows_aligned(v, vs) && rows_aligned(out, os)))
    return (int)cudaErrorMisalignedAddress;
  if (D == 16)  // the 64-wide tile, zero-filled past D
    return (int)tc::launch<64, 16>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 32)
    return (int)tc::launch<64, 32>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 64) return (int)tc::launch<64, 64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 80)  // the 128-wide tile, zero-filled past D
    return (int)tc::launch<128, 80>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 128) return (int)tc::launch<128, 128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The bytes of flash_attention_bwd's workspace `work` for these shapes and
// dtype, written to *bytes: f32 delta (B, Hq, Sq) for f32; for bf16 the
// one pass's lse2, delta, dQ counters and f32 dQ sums, with GQA also f32
// dK and dV partials of every query head.
int flash_attention_bwd_workspace(int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                  long long* bytes) {
  *bytes = 0;
  if (B < 0 || Hq < 0 || Hkv <= 0 || Sq < 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  if (dtype == F32) *bytes = (long long)B * Hq * Sq * 4;
  else if (dtype == BF16) *bytes = bw::one::workspace(B, Hq, Hkv, Sq, Skv, D).bytes;
  else return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// The backward of flash_attention: dq (B, Sq, Hq, D), dk and dv (B, Skv, Hkv, D)
// from q, k, v, the forward's output o and log-sum-exp lse (B, Hq, Sq) f32,
// and the output's gradient dout; `work` is scratch of
// flash_attention_bwd_workspace bytes, 256-byte aligned.  Every (B, S, H, D)
// tensor through element strides as flash_attention's.  Up to three
// launches on the stream (each skipped where its grid is empty), *launched
// set to how many were made: f32 delta = rowsum(dout * o), dK/dV, dQ; bf16
// the pre-pass (delta, lse2, zeroed dQ sums and counters), the one pass
// (dK, dV and the ordered dQ sum), dQ's rounding.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* work, void* dq, void* dk,
                        void* dv, int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                        const long long* strides, float scale, int causal, void* stream,
                        int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0) return (int)cudaGetLastError();
  // strides: (batch, seq, head) of q, k, v, o, dout, dq, dk, dv in order
  Strides s[8];
  for (int i = 0; i < 8; ++i) s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float* l = static_cast<const float*>(lse);
  if (dtype == F32)
    return (int)bw::launch_d<float>(D, q, k, v, o, dout, l, work, dq, dk, dv, B, Hq, Hkv, Sq,
                                    Skv, s, scale, causal, st, launched);
  if (dtype == BF16) {
    if (!(rows_aligned(q, s[0]) && rows_aligned(k, s[1]) && rows_aligned(v, s[2]) &&
          rows_aligned(dout, s[4])))
      return (int)cudaErrorMisalignedAddress;
    return (int)bw::launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, work, dq, dk, dv, B, Hq, Hkv,
                                            Sq, Skv, s, scale, causal, st, launched);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
