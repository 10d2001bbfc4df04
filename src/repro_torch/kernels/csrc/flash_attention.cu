// Flash (online-softmax) attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention/flash.py (flash_attention): softmax(q k^T
// * scale) v per query head, with query head h reading kv head h / group
// (GQA, no copy of K/V), the causal mask q_pos >= k_pos counted from 0 for
// both, running max / denominator / accumulator in f32, and the output
// divided by max(l, 1e-30) so a row that sees no key stays finite.
//
// What bounds it on this card: operations.  Causal attention over S tokens
// does about 2*H*S*S*D flops (two products, half the tiles) on 4*H*S*D
// elements of q, k, v and o, hundreds of flops per byte at prefill lengths.
// This first kernel runs them in f32 on the CUDA cores, so it is far from
// the tensor-core bound; wgmma, TMA and pipelining are later work.  The
// design:
//   * one block per (batch, query head, BQ-row query tile); the TPU's
//     sequential kv grid axis becomes a loop inside the block, with m, l
//     and the (BQ, D) accumulator in registers (4 rows x D/16 columns a
//     thread) instead of VMEM scratch;
//   * each kv tile of BKV keys is staged in shared memory as f32 (K with a
//     padded row pitch so the 16 lanes of a row group hit distinct banks);
//     the BQ x BKV scores live in registers, the row max and row sum are
//     reduced with shuffles across the 16 lanes that share a row, and the
//     probabilities go through shared memory into the P.V product;
//   * causal tiles wholly in the future of the query tile are skipped, and
//     p is zeroed where masked, so a fully masked tile adds nothing;
//   * ragged Sq/Skv are masked (no divisibility requirement, unlike the
//     TPU blocks: a prefill bucket can be 8 tokens);
//   * q, k, v and o are read and written through (batch, seq, head)
//     strides in the model layout (B, S, H, D), so the caller makes no
//     transposing copy.  expf (not __expf) keeps f32 within 2e-5 of the
//     plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 32;        // keys per kv tile
constexpr int TX = 16;         // lanes sharing a query row
constexpr int TY = 16;         // row groups
constexpr int NTHREADS = TX * TY;
constexpr int RQ = BQ / TY;    // query rows per thread
constexpr int CK = BKV / TX;   // score columns per thread
constexpr float NEG = -1e30f;  // the mask value of the JAX kernel

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Skv, int group, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal) {
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? to_f32(qb[qi * qs.s + d]) : 0.f;
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
      Ks[c * LD + d] = ok ? to_f32(kb[kj * ks.s + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f32(vb[kj * vs.s + d]) : 0.f;
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
    T* orow = out + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < CD; ++j) orow[tx + TX * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                   int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  dim3 block(TX, TY);
  flash_kernel<T, D><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, Hq / Hkv, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B,
                     int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale, int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (B, Sq, Hq, D) = attention of q (B, Sq, Hq, D) over k, v (B, Skv, Hkv, D),
// every tensor addressed as base + b*sb + s*ss + h*sh + d (element strides,
// d contiguous).  D is 64 or 128; Hq a multiple of Hkv; Hq, B <= 65535.
int flash_attention(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                    int Hq, int Hkv, int Sq, int Skv, int D, long long qsb, long long qss,
                    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
                    long long vss, long long vsh, long long osb, long long oss, long long osh,
                    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaError_t err;
  if (dtype == F32)
    err = launch_d<float>(D, q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, st);
  else if (dtype == BF16)
    err = launch_d<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale,
                                  causal, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
