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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr float NEG = -1e30f;  // the mask value of the JAX kernel

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
             const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv, int group,
             Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
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
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                   int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  dim3 block(TX, TY);
  flash_kernel<D><<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Skv, Hq / Hkv, qs, ks, vs, os, scale, causal);
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
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int Sq, int Skv,
                int group, Strides os, float scale_log2, int causal) {
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                   int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
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
      tq, tk, tv, static_cast<bf16*>(out), Sq, Skv, Hq / Hkv, os, scale * 1.4426950408889634f,
      causal);
  return cudaGetLastError();
}

}  // namespace tc

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
int flash_attention(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                    int Hq, int Hkv, int Sq, int Skv, int D, long long qsb, long long qss,
                    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
                    long long vss, long long vsh, long long osb, long long oss, long long osh,
                    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  if (dtype == F32) {
    if (D == 64) return (int)cc::launch<64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 80) return (int)cc::launch<80>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    if (D == 128) return (int)cc::launch<128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  if (Skv <= 0) return (int)cudaErrorInvalidValue;  // a tensor map needs a row
  if (!(rows_aligned(q, qs) && rows_aligned(k, ks) && rows_aligned(v, vs) && rows_aligned(out, os)))
    return (int)cudaErrorMisalignedAddress;
  if (D == 64) return (int)tc::launch<64, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 80)  // the 128-wide tile, zero-filled past D
    return (int)tc::launch<128, 80>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  if (D == 128) return (int)tc::launch<128, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
