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

namespace {

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Dims4 {
  int64_t n[4];    // window extents, outermost first
  int64_t src[4];  // source strides in elements
  int64_t dst[4];  // destination strides in elements
};

template <typename Tin, typename Tout>
__global__ void copy_convert_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst,
                                    Dims4 d, int64_t total, float scale) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += step) {
    int64_t rem = e;
    const int64_t i3 = rem % d.n[3]; rem /= d.n[3];
    const int64_t i2 = rem % d.n[2]; rem /= d.n[2];
    const int64_t i1 = rem % d.n[1];
    const int64_t i0 = rem / d.n[1];
    const int64_t s = i0 * d.src[0] + i1 * d.src[1] + i2 * d.src[2] + i3 * d.src[3];
    const int64_t o = i0 * d.dst[0] + i1 * d.dst[1] + i2 * d.dst[2] + i3 * d.dst[3];
    dst[o] = from_f32<Tout>(to_f32(src[s]) * scale);
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

template <typename Tin, typename Tout>
void launch_copy(const void* src, void* dst, const Dims4& d, int64_t total, float scale,
                 cudaStream_t stream) {
  copy_convert_kernel<Tin, Tout><<<blocks_for(total, 1 << 20), kThreads, 0, stream>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(dst), d, total, scale);
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

// dst[window] = convert(src[window] * scale) over a 4-D window with
// arbitrary strides.  Returns cudaGetLastError() after the launch.
int copy_convert(const void* src, int src_dtype, void* dst, int dst_dtype,
                 int64_t n0, int64_t n1, int64_t n2, int64_t n3,
                 int64_t s0, int64_t s1, int64_t s2, int64_t s3,
                 int64_t d0, int64_t d1, int64_t d2, int64_t d3,
                 float scale, void* stream) {
  Dims4 d = {{n0, n1, n2, n3}, {s0, s1, s2, s3}, {d0, d1, d2, d3}};
  const int64_t total = n0 * n1 * n2 * n3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (src_dtype == F32 && dst_dtype == F32) launch_copy<float, float>(src, dst, d, total, scale, st);
    else if (src_dtype == F32 && dst_dtype == BF16) launch_copy<float, __nv_bfloat16>(src, dst, d, total, scale, st);
    else if (src_dtype == BF16 && dst_dtype == F32) launch_copy<__nv_bfloat16, float>(src, dst, d, total, scale, st);
    else if (src_dtype == BF16 && dst_dtype == BF16) launch_copy<__nv_bfloat16, __nv_bfloat16>(src, dst, d, total, scale, st);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
