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
// H, D); any Sq/Skv (ragged tiles are masked); D is 64, 80 or 128.
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
// * f32: flash_kernel, the first CUDA-core kernel of the port, unchanged in
//   its arithmetic (D = 80: 5 accumulator columns a thread, 48.6 KB of
//   shared memory).  The f32 tolerance (2e-5 against the plain version) cannot
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
// autograd graph).  FlashAttention-2's algorithm in three launches, no
// atomics, so the result is bitwise repeatable:
//   1. delta = rowsum(dO * O), one warp a row, f32;
//   2. dK, dV: a block owns a tile of keys of one kv head and loops over
//      its group's query heads (GQA sums in registers) and the query tiles
//      from the causal start: P = exp(scale S - lse) recomputed from Q K^T,
//      dV += P^T dO, dP = dO V^T, dS = P (dP - delta), dK += scale dS^T Q;
//   3. dQ: a block owns a tile of query rows and loops over the kv tiles
//      up to the causal end, recomputing S and dP: dQ = scale dS K.  The
//      recompute costs 7 products against one pass's 5 (dQ by f32 atomics
//      would save two, but sum in run-to-run order).
// What bounds it: operations, 2.5x the forward's (5 products against 2).
// * bf16: tensor cores through mma.sync m16n8k16 (bf16 x bf16 -> f32),
//   4 warps a block of 16 rows each; tiles of bf16 rows in shared memory
//   with 16 bytes of padding a row, so the 8 rows an ldmatrix reads sit in
//   distinct bank groups; S^T and dP^T (dK/dV) or S and dP (dQ) stay in
//   registers and become, rounded to bf16, the A fragments of the next
//   products (their C and A fragments share a thread layout), B read by
//   ldmatrix (.trans where the contraction runs along shared-memory rows).
//   exp2 on the special-function unit.  Rows 16-byte aligned (the wrapper
//   checks).  A wgmma/TMA design with warp specialisation is later work.
// * f32: CUDA cores, f32 products, expf, the same tiling in f32 shared
//   memory (the 1e-4 tolerance of the f32 route rules out bf16 operands).

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

// DT: the tile width (64, or 128 for D = 80 and 128); D: the real head dim
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
// backward (flash_attention_bwd): the f32 route on CUDA cores, the bf16
// route on tensor cores; the delta pre-pass for both
// ---------------------------------------------------------------------------
namespace bw {

constexpr int TX = 16, TY = 16, NTHREADS = TX * TY;
constexpr int KV_BKV = 64, KV_BQ = 32;  // dK/dV: keys a block, query rows a step
constexpr int Q_BQ = 64, Q_BKV = 32;    // dQ: query rows a block, keys a step

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

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
template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int Hq, int Sq, Strides os, Strides dos) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;  // over (B, Hq, Sq)
  if (row >= (long long)B * Hq * Sq) return;
  const int s = (int)(row % Sq), h = (int)((row / Sq) % Hq), b = (int)(row / ((long long)Sq * Hq));
  const T* orow = o + b * os.b + s * os.s + h * os.h;
  const T* drow = dout + b * dos.b + s * dos.s + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(ldf(orow + d), ldf(drow + d), acc);
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

// ---- the bf16 route: tensor cores (mma.sync m16n8k16, bf16 in, f32 sums) ----
//
// Tiles are bf16 rows in shared memory with a pitch of D + 8 elements (16
// bytes of padding: the 8 rows an ldmatrix reads fall in 8 distinct 16-byte
// bank groups).  A block is 4 warps; a warp owns 16 rows of its product.

constexpr int TC_WARPS = 4, TC_THREADS = 32 * TC_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d (16 x 8) += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8 NJ) += A B^T over k < D: A 16 rows at sA, B 8 NJ rows at sB,
// both bf16 row-major (k along a row) with pitch P
template <int NJ, int D, int P>
__device__ __forceinline__ void mma_nt(float (&acc)[NJ][4], uint32_t sA, uint32_t sB, int lane) {
  const int r = lane & 7, m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sA + ((8 * (m & 1) + r) * P + 16 * kk + 8 * (m >> 1)) * 2);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, sB + ((8 * j + 8 * (m >> 1) + r) * P + 16 * kk + 8 * (m & 1)) * 2);
      mma16816(acc[j], a, b[0], b[1]);
      mma16816(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8 ND) += A B: A (16 x 16 KS) in registers as mma A fragments,
// B (16 KS x 8 ND) bf16 row-major (k along the rows) at sB with pitch P,
// read transposed by ldmatrix
template <int ND, int KS, int P>
__device__ __forceinline__ void mma_rn(float (&acc)[ND][4], const uint32_t (&a)[KS][4],
                                       uint32_t sB, int lane) {
  const int r = lane & 7, m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < ND; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, sB + ((16 * kk + 8 * (m & 1) + r) * P + 8 * j + 8 * (m >> 1)) * 2);
      mma16816(acc[j], a[kk], b[0], b[1]);
      mma16816(acc[j + 1], a[kk], b[2], b[3]);
    }
}

// C fragments of 2 KS n-tiles (16 x 16 KS, f32) as the A fragments of a
// product over those columns, rounded to bf16
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

// rows [r0, r0 + n) of one head of a (B, S, H, D) bf16 tensor into shared
// memory (pitch P), 16 bytes a thread, zeros past S; rows 16-byte aligned
template <int D, int P>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long ss, int r0, int n, int S) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < n * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) val = *reinterpret_cast<const uint4*>(base + row * ss + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * P + 8 * c) = val;
  }
}

// lse in the log2 domain for exp2: +inf for a row past Sq or one that saw
// no key, so its p is exp2(-inf) = 0
__device__ __forceinline__ float lse2_of(const float* lse, int row, int Sq) {
  const float l = row < Sq ? lse[row] : neg_inf();
  return l == neg_inf() ? __int_as_float(0x7f800000) : l * LOG2E;
}

template <int D>
__host__ __device__ constexpr int tc_rows() { return D <= 80 ? 64 : 32; }  // a step tile's rows

template <int D>
constexpr int dkdv_tc_smem() {
  return (2 * 64 + 2 * tc_rows<D>()) * (D + 8) * 2 + 2 * tc_rows<D>() * 4;
}
template <int D>
constexpr int dq_tc_smem() { return (2 * 64 + 2 * tc_rows<D>()) * (D + 8) * 2; }

// dK and dV of 64 keys of one kv head (16 a warp): over its group's query
// heads and the query tiles from the causal start, S^T = K Q^T and
// dP^T = V dO^T, then P^T and dS^T in registers feed dV += P^T dO and
// dK += dS^T Q as A fragments
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Hq, int Sq,
               int Skv, int group, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
               Strides dvs, float scale, int causal) {
  constexpr int BC = 64, BR = tc_rows<D>(), P = D + 8;
  constexpr int NJ = BR / 8, ND = D / 8, KS = BR / 16;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + BC * P;
  bf16* Qs = Vs + BC * P;
  bf16* dOs = Qs + BR * P;
  float* Ls = reinterpret_cast<float*>(dOs + BR * P);
  float* Dl = Ls + BR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BC, hk = blockIdx.y, b = blockIdx.z;
  const int kw = k0 + 16 * warp;  // this warp's first key
  load_tile<D, P>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BC, Skv);
  load_tile<D, P>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BC, Skv);
  const uint32_t sK = tc::smem_u32(Ks + 16 * warp * P), sV = tc::smem_u32(Vs + 16 * warp * P);
  const uint32_t sQ = tc::smem_u32(Qs), sdO = tc::smem_u32(dOs);
  const float scale_log2 = scale * LOG2E;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int qstart = causal ? (k0 / BR) * BR : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* dob = dout + b * dos.b + h * dos.h;
    const long long so = ((long long)b * Hq + h) * Sq;
    for (int q0 = qstart; q0 < Sq; q0 += BR) {
      __syncthreads();  // the previous step's Q, dO and stats are no longer read
      load_tile<D, P>(Qs, qb, qs.s, q0, BR, Sq);
      load_tile<D, P>(dOs, dob, dos.s, q0, BR, Sq);
      if (tid < BR) {
        Ls[tid] = lse2_of(lse + so, q0 + tid, Sq);
        Dl[tid] = q0 + tid < Sq ? delta[so + q0 + tid] : 0.f;
      }
      __syncthreads();
      if (causal && kw > q0 + BR - 1) continue;  // every key of the warp after every row

      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_nt<NJ, D, P>(s, sK, sQ, lane);
      mma_nt<NJ, D, P>(dp, sV, sdO, lane);
      // rows: keys kw + g (+8); columns: query rows q0 + 8j + 2t (+1)
      const bool mask = kw + 15 >= Skv || q0 + BR > Sq || (causal && kw + 15 > q0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1), key = kw + g + 8 * (e >> 1);
          float p = tc::fast_exp2(s[j][e] * scale_log2 - Ls[ql]);
          if (mask && (key >= Skv || (causal && key > q0 + ql))) p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dl[ql]);
        }
      uint32_t pa[KS][4], da[KS][4];
      to_a<KS>(pa, s);
      to_a<KS>(da, dp);
      mma_rn<ND, KS, P>(dv_acc, pa, sdO, lane);
      mma_rn<ND, KS, P>(dk_acc, da, sQ, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= Skv) continue;
    bf16* dkrow = dk + b * dks.b + key * dks.s + hk * dks.h + 2 * t;
    bf16* dvrow = dv + b * dvs.b + key * dvs.s + hk * dvs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// dQ of 64 query rows of one query head (16 a warp), over the kv tiles up
// to the causal end (the longest rows' blocks first): S = Q K^T and
// dP = dO V^T, then dS in registers feeds dQ += dS K
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int Hq, int Sq, int Skv, int group, Strides qs,
             Strides ks, Strides vs, Strides dos, Strides dqs, float scale, int causal) {
  constexpr int BQ = 64, BK = tc_rows<D>(), P = D + 8;
  constexpr int NJ = BK / 8, ND = D / 8, KS = BK / 16;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dOs = Qs + BQ * P;
  bf16* Ks = dOs + BQ * P;
  bf16* Vs = Ks + BK * P;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group, qw = q0 + 16 * warp;  // this warp's first row
  const long long so = ((long long)b * Hq + h) * Sq;
  load_tile<D, P>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq);
  load_tile<D, P>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BQ, Sq);
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const uint32_t sQ = tc::smem_u32(Qs + 16 * warp * P), sdO = tc::smem_u32(dOs + 16 * warp * P);
  const uint32_t sK = tc::smem_u32(Ks), sV = tc::smem_u32(Vs);
  const float scale_log2 = scale * LOG2E;
  float L[2], Dr[2];  // this thread's rows qw + g, qw + g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    L[r] = lse2_of(lse + so, row, Sq);
    Dr[r] = row < Sq ? delta[so + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Q and dO are in; the previous K and V are no longer read
    load_tile<D, P>(Ks, kb, ks.s, k0, BK, Skv);
    load_tile<D, P>(Vs, vb, vs.s, k0, BK, Skv);
    __syncthreads();
    if (causal && k0 > qw + 15) continue;  // every key after every row of the warp

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nt<NJ, D, P>(s, sQ, sK, lane);
    mma_nt<NJ, D, P>(dp, sdO, sV, lane);
    // rows: query rows qw + g (+8); columns: keys k0 + 8j + 2t (+1)
    const bool mask = k0 + BK > Skv || qw + 15 >= Sq || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
        float p = tc::fast_exp2(s[j][e] * scale_log2 - L[r]);
        if (mask && (key >= Skv || (causal && key > qw + g + 8 * r))) p = 0.f;
        dp[j][e] = p * (dp[j][e] - Dr[r]);
      }
    uint32_t da[KS][4];
    to_a<KS>(da, dp);
    mma_rn<ND, KS, P>(acc, da, sK, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    if (row >= Sq) continue;
    bf16* out = dq + b * dqs.b + row * dqs.s + h * dqs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// the dK/dV and dQ kernels of a route, their rows a block and shared memory
template <typename T, int D>
struct Route;
template <int D>
struct Route<float, D> {  // CUDA cores
  static constexpr auto dkdv = dkdv_kernel<D>;
  static constexpr auto dq = dq_kernel<D>;
  static constexpr int kv_rows = KV_BKV, q_rows = Q_BQ;
  static constexpr int dkdv_smem = dkdv_smem_floats<D>() * 4, dq_smem = dq_smem_floats<D>() * 4;
  static dim3 block() { return dim3(TX, TY); }
};
template <int D>
struct Route<__nv_bfloat16, D> {  // tensor cores
  static constexpr auto dkdv = dkdv_tc_kernel<D>;
  static constexpr auto dq = dq_tc_kernel<D>;
  static constexpr int kv_rows = 64, q_rows = 64;
  static constexpr int dkdv_smem = dkdv_tc_smem<D>(), dq_smem = dq_tc_smem<D>();
  static dim3 block() { return dim3(TC_THREADS); }
};

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                   Strides dos, Strides dqs, Strides dks, Strides dvs, float scale, int causal,
                   cudaStream_t st, int* launched) {
  using R = Route<T, D>;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
  const long long rows = (long long)B * Hq * Sq;
  if (rows > 0) {
    delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
        static_cast<const T*>(o), tdo, delta, B, Hq, Sq, os, dos);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (Skv > 0) {
    cudaError_t err = cudaFuncSetAttribute(R::dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           R::dkdv_smem);
    if (err != cudaSuccess) return err;
    R::dkdv<<<dim3((Skv + R::kv_rows - 1) / R::kv_rows, Hkv, B), R::block(), R::dkdv_smem, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Sq, Skv,
        Hq / Hkv, qs, ks, vs, dos, dks, dvs, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (Sq > 0) {
    cudaError_t err = cudaFuncSetAttribute(R::dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           R::dq_smem);
    if (err != cudaSuccess) return err;
    R::dq<<<dim3((Sq + R::q_rows - 1) / R::q_rows, Hq, B), R::block(), R::dq_smem, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Hq, Sq, Skv, Hq / Hkv, qs, ks, vs, dos,
        dqs, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
                     Strides vs, Strides os, Strides dos, Strides dqs, Strides dks, Strides dvs,
                     float scale, int causal, cudaStream_t st, int* launched) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv, qs, ks,
                         vs, os, dos, dqs, dks, dvs, scale, causal, st, launched);
  if (D == 80)
    return launch<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv, qs, ks,
                         vs, os, dos, dqs, dks, dvs, scale, causal, st, launched);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv, qs, ks,
                          vs, os, dos, dqs, dks, dvs, scale, causal, st, launched);
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
// d contiguous; a unit dim's stride may be given as 0).  D is 64, 80 or 128; Hq
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
    if (D == 64) return (int)cc::launch<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 80) return (int)cc::launch<80>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 128) return (int)cc::launch<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  if (Skv <= 0) return (int)cudaErrorInvalidValue;  // a tensor map needs a row
  if (!(rows_aligned(q, qs) && rows_aligned(k, ks) && rows_aligned(v, vs) && rows_aligned(out, os)))
    return (int)cudaErrorMisalignedAddress;
  if (D == 64) return (int)tc::launch<64, 64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 80)  // the 128-wide tile, zero-filled past D
    return (int)tc::launch<128, 80>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 128) return (int)tc::launch<128, 128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of flash_attention: dq (B, Sq, Hq, D), dk and dv (B, Skv, Hkv, D)
// from q, k, v, the forward's output o and log-sum-exp lse (B, Hq, Sq) f32,
// and the output's gradient dout; delta (B, Hq, Sq) f32 is scratch.  Every
// (B, S, H, D) tensor through element strides as flash_attention's.  Up to
// three launches on the stream: delta = rowsum(dout * o), dK/dV, dQ (each
// skipped where its grid is empty); *launched is set to how many were made.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
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
  float* dl = static_cast<float*>(delta);
  if (dtype == F32)
    return (int)bw::launch_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Skv,
                                    s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], scale,
                                    causal, st, launched);
  if (dtype == BF16)
    return (int)bw::launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv,
                                            Sq, Skv, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                                            s[7], scale, causal, st, launched);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
