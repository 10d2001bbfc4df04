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
// gather_pack reads a work table that the wrapper builds once per layout
// (kernels/pack/pack.py work_rows) and a persistent plan uploads once.
// Each segment window is collapsed like copy_convert's (a face to one run,
// a py face of a heat3d block to rows of 512) and cut into chunks of one
// segment's rows: wire offset, source offset, row count, run, source row
// stride, a power-of-two count of threads a row, and the largest vector
// (8, 4, 2 or 1 elements) that every row start of the chunk is aligned to
// on both sides.  Chunks are about 4096 elements, so the pz face of the
// heat3d block splits into 65 blocks a rank and a small edge or corner
// segment is a chunk of its own.  blockIdx.x is a chunk, blockIdx.y the
// rank.  Threads map to (row, lane) by a shift and a mask; a row moves 16
// bytes of the wider type a thread where the chunk and the launch are
// aligned (else one element a thread), four vectors loaded before any is
// stored.  No table search and no division.
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

// work table: nchunk rows of kWorkCols int64 = (wire offset, source offset,
// rows, run, source row stride, log2 threads a row, alignment); rows of a
// chunk lie end to end in the wire (destination row stride = run).
constexpr int kWorkCols = 7;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread loads before it stores them

template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads)
gather_pack_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                   const int64_t* __restrict__ work, int64_t total, int64_t rank_stride,
                   int vec_ok, float scale) {
  const int64_t* c = work + (int64_t)blockIdx.x * kWorkCols;
  const int rows = (int)c[2], run = (int)c[3], shift = (int)c[5];
  const int64_t srow = c[4];
  const Tin* xs = x + blockIdx.y * rank_stride + c[1];
  Tout* od = out + blockIdx.y * total + c[0];
  const int tpr = 1 << shift, lane = threadIdx.x & (tpr - 1);
  const int row_step = kThreads >> shift;
  const int k0 = threadIdx.x >> shift;
  if (V > 1 && vec_ok && c[6] % V == 0) {
    // slots (row k, vector e) of this thread in order, kUnroll loads
    // issued before the first store
    const int nvec = run / V;
    int k = lane < nvec ? k0 : rows, e = lane;
    while (k < rows) {
      float f[kUnroll][V];
      Tout* dst[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dst[u] = nullptr;
        if (k < rows) {
          load_vec<V>(xs + k * srow + e * V, f[u]);
          dst[u] = od + (int64_t)k * run + e * V;
          e += tpr;
          if (e >= nvec) { e = lane; k += row_step; }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (dst[u] == nullptr) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) f[u][j] *= scale;
        store_vec<V>(dst[u], f[u]);
      }
    }
    for (k = k0; k < rows; k += row_step)  // the scalar tail of each row
      for (e = nvec * V + lane; e < run; e += tpr)
        od[(int64_t)k * run + e] = from_f32<Tout>(to_f32(xs[k * srow + e]) * scale);
  } else {
    for (int k = k0; k < rows; k += row_step)
      for (int e = lane; e < run; e += tpr)
        od[(int64_t)k * run + e] = from_f32<Tout>(to_f32(xs[k * srow + e]) * scale);
  }
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
int launch_gather(const void* x, void* out, const void* work, int nchunk, int64_t total,
                  int ranks, int64_t rank_stride, int vec_ok, float scale, cudaStream_t stream) {
  constexpr int WIDE = 16 / (sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  // the wrapper vouched for the launch's alignment; refuse what it cannot carry
  if (vec_ok && (reinterpret_cast<uintptr_t>(x) % (WIDE * sizeof(Tin)) ||
                 reinterpret_cast<uintptr_t>(out) % (WIDE * sizeof(Tout)) ||
                 rank_stride % WIDE || total % WIDE))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid(nchunk, ranks);
  gather_pack_kernel<Tin, Tout, WIDE><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), static_cast<const int64_t*>(work),
      total, rank_stride, vec_ok, scale);
  return 0;
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
// `ranks` stacked blocks of `rank_stride` elements, through the (nchunk, 7)
// work table.  vec_ok: both bases, rank_stride and total are aligned to 16
// bytes of the wider type (then each chunk aligned to it moves vectors).
int gather_pack(const void* x, int x_dtype, void* out, int out_dtype, const void* work,
                int nchunk, int64_t total, int ranks, int64_t rank_stride, int vec_ok,
                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nchunk <= 0 || ranks <= 0) return (int)cudaGetLastError();
  int err;
  if (x_dtype == F32 && out_dtype == F32)
    err = launch_gather<float, float>(x, out, work, nchunk, total, ranks, rank_stride, vec_ok, scale, st);
  else if (x_dtype == F32 && out_dtype == BF16)
    err = launch_gather<float, __nv_bfloat16>(x, out, work, nchunk, total, ranks, rank_stride, vec_ok, scale, st);
  else if (x_dtype == BF16 && out_dtype == F32)
    err = launch_gather<__nv_bfloat16, float>(x, out, work, nchunk, total, ranks, rank_stride, vec_ok, scale, st);
  else if (x_dtype == BF16 && out_dtype == BF16)
    err = launch_gather<__nv_bfloat16, __nv_bfloat16>(x, out, work, nchunk, total, ranks, rank_stride, vec_ok, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
