// Halo pack/unpack kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pack/pack.py:
//   * copy_convert  <- _copy_convert_kernel (pack_2d / unpack_2d): a copy
//     of one batched slab window with dtype convert (f32 <-> bf16) and an
//     optional scale applied in f32.
//   * gather_pack   <- _gather_pack_kernel (gather_pack_1d): every
//     (offset, start, shape) window of a ghosted block gathered into one
//     contiguous wire buffer in one launch.
//
// What bounds them on this card: bytes.  Each element is read once and
// written once with one multiply, so the least time is (bytes in + bytes
// out) / 3.35 TB/s.  The design does three things about that:
//   * copy_convert takes the source and destination strides, so a pack
//     reads the ghost slab in place and an unpack writes straight into the
//     ghost window: no staging copy and no update-slice copy around it.
//   * one launch covers all R stacked ranks (the windows are the same on
//     every rank), so a message costs one launch, not R.
//   * consecutive threads walk the innermost (contiguous) dim, so reads and
//     writes coalesce.  Ragged tails are masked by the bounds test; nothing
//     is padded (the TPU kernel padded to its 256x256 tile and cropped).
// copy_convert takes its window already collapsed by the wrapper
// (kernels/pack/pack.py collapse_window: unit dims dropped, dims contiguous
// on both sides merged) into up to three row dims and one run.  blockIdx.z
// walks row dim 0 and blockIdx.y rows (1, 2), split with one 32-bit division
// per row; the threads of blockIdx.x walk the run.  Where the run is
// contiguous on both sides and the wrapper found every row aligned to the
// vector on both sides (vec = 16 bytes of the wider type: 8 elements bf16 to
// bf16, else 4, an f32 side a float4 and a bf16 side 8 bytes), each thread
// moves one vector and a scalar tail finishes the run, so every warp
// instruction covers one contiguous span on each side (16 bytes of the
// narrower type would give an f32 side two float4 a thread, 32 bytes apart,
// and half-sector stores); otherwise each thread moves one element through
// the run strides.  No per-element % or /.
// The segment table of gather_pack is a device tensor that a persistent
// plan uploads once; each block copies it to shared memory and every
// thread finds its segment by binary search over the offsets.  There is no
// size budget: the TPU kernel's 4 MB VMEM limit has no counterpart here.
//
// Rounding: f32 -> bf16 is round-to-nearest-even (__float2bfloat16_rn), as
// jnp's and torch's casts are.  Every value is taken to f32 and multiplied
// by `scale` (1.0f is exact), then converted to the output type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Rows {
  int64_t n0;        // extent of row dim 0 (grid z)
  uint32_t n1, n2;   // extents of row dims 1 and 2 (grid y walks n1 * n2)
  int64_t src[3];    // source row strides in elements
  int64_t dst[3];    // destination row strides in elements
};

// V consecutive elements as f32 (V a multiple of 4, aligned to V elements)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = t.x; f[4 * i + 1] = t.y; f[4 * i + 2] = t.z; f[4 * i + 3] = t.w;
  }
}
// bf16: V = 4 (one 8-byte access) or 8 (one 16-byte access)
template <int V>
using BfVec = typename std::conditional<V == 8, uint4, uint2>::type;

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[V]) {
  const BfVec<V> t = *reinterpret_cast<const BfVec<V>*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const float2 g = __bfloat1622float2(h[j]);
    f[2 * j] = g.x; f[2 * j + 1] = g.y;
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&f)[V]) {
  BfVec<V> t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int j = 0; j < V / 2; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<BfVec<V>*>(p) = t;
}

// V == 1: one element a thread through the run strides (any strides).
// V > 1: the run is contiguous on both sides and every row starts aligned
// to V elements on both sides; nvec = run / V vectors, then a scalar tail.
template <typename Tin, typename Tout, int V>
__global__ void copy_convert_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst, Rows rw,
                                    int64_t run, int64_t nvec, int64_t src_run, int64_t dst_run,
                                    float scale) {
  const uint32_t rows12 = rw.n1 * rw.n2;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = blockIdx.z; i0 < rw.n0; i0 += gridDim.z) {
    for (uint32_t y = blockIdx.y; y < rows12; y += gridDim.y) {
      const uint32_t i1 = y / rw.n2, i2 = y - i1 * rw.n2;  // once per row, 32-bit
      const Tin* s = src + i0 * rw.src[0] + i1 * rw.src[1] + i2 * rw.src[2];
      Tout* d = dst + i0 * rw.dst[0] + i1 * rw.dst[1] + i2 * rw.dst[2];
      if (V > 1) {
        for (int64_t e = first; e < nvec; e += step) {
          float f[V];
          load_vec<V>(s + e * V, f);
#pragma unroll
          for (int j = 0; j < V; ++j) f[j] *= scale;
          store_vec<V>(d + e * V, f);
        }
        for (int64_t e = nvec * V + first; e < run; e += step)
          d[e] = from_f32<Tout>(to_f32(s[e]) * scale);
      } else {
        for (int64_t e = first; e < run; e += step)
          d[e * dst_run] = from_f32<Tout>(to_f32(s[e * src_run]) * scale);
      }
    }
  }
}

// table: nseg rows of 7 int64 = (offset, start[3], shape[3]) in local
// coordinates, local dims padded to 3 (leading dims of extent 1).
constexpr int kSegCols = 7;

template <typename Tin, typename Tout>
__global__ void gather_pack_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                                   const int64_t* __restrict__ table, int nseg,
                                   int64_t total, int64_t rank_stride,
                                   int64_t st0, int64_t st1, float scale) {
  extern __shared__ int64_t tab[];
  for (int i = threadIdx.x; i < nseg * kSegCols; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int64_t r = blockIdx.y;
  const Tin* xr = x + r * rank_stride;
  Tout* outr = out + r * total;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += step) {
    int lo = 0, hi = nseg - 1;  // last segment whose offset <= e
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab[mid * kSegCols] <= e) lo = mid; else hi = mid - 1;
    }
    const int64_t* s = tab + lo * kSegCols;
    int64_t rem = e - s[0];
    const int64_t i2 = rem % s[6]; rem /= s[6];
    const int64_t i1 = rem % s[5];
    const int64_t i0 = rem / s[5];
    const int64_t src = (s[1] + i0) * st0 + (s[2] + i1) * st1 + (s[3] + i2);
    outr[e] = from_f32<Tout>(to_f32(xr[src]) * scale);
  }
}

constexpr int kThreads = 256;

inline int blocks_for(int64_t n, int64_t cap) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

template <typename Tin, typename Tout, int V>
void launch_copy_v(const void* src, void* dst, const Rows& rw, int64_t run, int64_t src_run,
                   int64_t dst_run, float scale, cudaStream_t stream) {
  const int64_t nvec = run / V;
  const int64_t work = V > 1 ? nvec + (run - nvec * V) : run;
  const int64_t rows12 = (int64_t)rw.n1 * rw.n2;
  int threads = 32;  // a short run (a py face row: 128 vectors) takes a small block
  while (threads < kThreads && threads < work) threads *= 2;
  const int64_t bx = (work + threads - 1) / threads;
  dim3 grid((unsigned)(bx < (1 << 16) ? bx : (1 << 16)),
            (unsigned)(rows12 < 65535 ? rows12 : 65535), (unsigned)(rw.n0 < 65535 ? rw.n0 : 65535));
  copy_convert_kernel<Tin, Tout, V><<<grid, threads, 0, stream>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(dst), rw, run, nvec, src_run, dst_run,
      scale);
}

template <typename Tin, typename Tout>
int launch_copy(const void* src, void* dst, const Rows& rw, int64_t run, int64_t src_run,
                int64_t dst_run, int vec, float scale, cudaStream_t stream) {
  constexpr int WIDE = 16 / (sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  if (vec == 1) {
    launch_copy_v<Tin, Tout, 1>(src, dst, rw, run, src_run, dst_run, scale, stream);
    return 0;
  }
  // the wrapper chose the vector; refuse one the pointers cannot carry
  if (vec != WIDE || src_run != 1 || dst_run != 1 ||
      reinterpret_cast<uintptr_t>(src) % (WIDE * sizeof(Tin)) ||
      reinterpret_cast<uintptr_t>(dst) % (WIDE * sizeof(Tout)))
    return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 3; ++i)
    if (rw.src[i] % WIDE || rw.dst[i] % WIDE) return (int)cudaErrorMisalignedAddress;
  launch_copy_v<Tin, Tout, WIDE>(src, dst, rw, run, src_run, dst_run, scale, stream);
  return 0;
}

template <typename Tin, typename Tout>
void launch_gather(const void* x, void* out, const void* table, int nseg, int64_t total,
                   int ranks, int64_t rank_stride, int64_t st0, int64_t st1, float scale,
                   cudaStream_t stream) {
  dim3 grid(blocks_for(total, 1 << 16), ranks);
  size_t smem = (size_t)nseg * kSegCols * sizeof(int64_t);
  gather_pack_kernel<Tin, Tout><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out),
      static_cast<const int64_t*>(table), nseg, total, rank_stride, st0, st1, scale);
}

}  // namespace

extern "C" {

// dst[window] = convert(src[window] * scale) over a window collapsed to
// rows (n0, n1, n2) of `run` elements: row (i0, i1, i2) starts at
// sum(i * s) in src and sum(i * d) in dst, element e of a run at e * srun
// and e * drun.  vec is 1 or 16 bytes of the wider type (then srun = drun =
// 1, both bases and every row stride aligned to vec elements; a row stride
// of a unit dim may be 0).  Returns cudaGetLastError() after the launch.
int copy_convert(const void* src, int src_dtype, void* dst, int dst_dtype,
                 int64_t n0, int64_t n1, int64_t n2, int64_t run,
                 int64_t s0, int64_t s1, int64_t s2, int64_t srun,
                 int64_t d0, int64_t d1, int64_t d2, int64_t drun,
                 int vec, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || run <= 0) return (int)cudaGetLastError();
  if (n1 * n2 > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  const Rows rw = {n0, (uint32_t)n1, (uint32_t)n2, {s0, s1, s2}, {d0, d1, d2}};
  int err;
  if (src_dtype == F32 && dst_dtype == F32)
    err = launch_copy<float, float>(src, dst, rw, run, srun, drun, vec, scale, st);
  else if (src_dtype == F32 && dst_dtype == BF16)
    err = launch_copy<float, __nv_bfloat16>(src, dst, rw, run, srun, drun, vec, scale, st);
  else if (src_dtype == BF16 && dst_dtype == F32)
    err = launch_copy<__nv_bfloat16, float>(src, dst, rw, run, srun, drun, vec, scale, st);
  else if (src_dtype == BF16 && dst_dtype == BF16)
    err = launch_copy<__nv_bfloat16, __nv_bfloat16>(src, dst, rw, run, srun, drun, vec, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return err ? err : (int)cudaGetLastError();
}

// out[r, :total] = every segment window of x[r] laid end to end, for all
// `ranks` stacked blocks of `rank_stride` elements.  Local block strides
// are (st0, st1, 1) after padding the local dims to 3.
int gather_pack(const void* x, int x_dtype, void* out, int out_dtype, const void* table,
                int nseg, int64_t total, int ranks, int64_t rank_stride, int64_t st0,
                int64_t st1, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total > 0 && ranks > 0) {
    if (x_dtype == F32 && out_dtype == F32)
      launch_gather<float, float>(x, out, table, nseg, total, ranks, rank_stride, st0, st1, scale, st);
    else if (x_dtype == F32 && out_dtype == BF16)
      launch_gather<float, __nv_bfloat16>(x, out, table, nseg, total, ranks, rank_stride, st0, st1, scale, st);
    else if (x_dtype == BF16 && out_dtype == F32)
      launch_gather<__nv_bfloat16, float>(x, out, table, nseg, total, ranks, rank_stride, st0, st1, scale, st);
    else if (x_dtype == BF16 && out_dtype == BF16)
      launch_gather<__nv_bfloat16, __nv_bfloat16>(x, out, table, nseg, total, ranks, rank_stride, st0, st1, scale, st);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
