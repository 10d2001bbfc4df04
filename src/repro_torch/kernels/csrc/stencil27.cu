// 27-point stencil update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _stencil_kernel of
// src/repro/kernels/stencil27/stencil27.py (stencil27): every interior
// cell of a ghosted (Z+2, Y+2, X+2) block becomes the weighted sum of its
// 3x3x3 neighbourhood, accumulated in f32 in dz -> dy -> dx order and
// stored in the input type.  Here one launch covers a batch of R blocks
// (all stacked ranks at once).
//
// What bounds it on this card: bytes.  27 multiply-adds per cell against
// 4 + 4 bytes (f32) of compulsory traffic is ~7 flop/byte, far below the
// ~20 flop/byte at which the 67 TFLOP/s f32 pipes would become the limit,
// so the least time is (input + output bytes) / 3.35 TB/s.  The design
// keeps each input read from device memory about once: a block owns a
// TY x TX column of outputs and marches up z through it, holding three
// (TY+2) x (TX+2) planes with their one-cell rim in shared memory as a
// ring; each step loads one new plane and reuses the other two.  The rim
// costs (TY+2)(TX+2)/(TY*TX) = 1.33x reads at TX=32, TY=8.  Ragged
// edges are masked, so any Z, Y, X >= 1 works, including the thin 3-cell
// shells of the overlap schedule (no divisibility requirement, unlike the
// TPU tile).
//
// Numerics: each term is w*x rounded, then added rounded
// (__fmul_rn/__fadd_rn), in the reference's order.  This stops nvcc from
// contracting to FMA, so the kernel matches its plain PyTorch version
// (separate mul and add per term) to the bit on finite inputs; the stated
// tolerance still allows for FMA-level differences.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int PX = TX + 2;
constexpr int PY = TY + 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void load_plane(float (*plane)[PX], const T* __restrict__ xr,
                                           int zin, int y0, int x0, int Y, int X,
                                           int64_t sz, int64_t sy, int tid) {
  for (int i = tid; i < PY * PX; i += TX * TY) {
    const int ly = i / PX, lx = i % PX;
    const int gy = y0 + ly, gx = x0 + lx;  // ghosted coordinates
    float v = 0.f;
    if (gy < Y + 2 && gx < X + 2) v = to_f32(xr[zin * sz + gy * sy + gx]);
    plane[ly][lx] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
stencil27_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ w,
                 int Z, int Y, int X, int tz, int zchunks) {
  __shared__ float planes[3][PY][PX];
  __shared__ float ws[27];
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (tid < 27) ws[tid] = w[tid];

  const int r = blockIdx.z / zchunks;
  const int z0 = (blockIdx.z % zchunks) * tz;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int zend = min(z0 + tz, Z);

  const int64_t sy = X + 2;
  const int64_t sz = (int64_t)(Y + 2) * sy;
  const T* xr = x + (int64_t)r * (Z + 2) * sz;
  T* outr = out + (int64_t)r * Z * Y * X;

  load_plane(planes[z0 % 3], xr, z0, y0, x0, Y, X, sz, sy, tid);
  load_plane(planes[(z0 + 1) % 3], xr, z0 + 1, y0, x0, Y, X, sz, sy, tid);
  const int oy = y0 + threadIdx.y, ox = x0 + threadIdx.x;
  for (int z = z0; z < zend; ++z) {
    load_plane(planes[(z + 2) % 3], xr, z + 2, y0, x0, Y, X, sz, sy, tid);
    __syncthreads();
    if (oy < Y && ox < X) {
      float acc = 0.f;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const float (*p)[PX] = planes[(z + dz) % 3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = __fadd_rn(acc, __fmul_rn(ws[dz * 9 + dy * 3 + dx],
                                           p[threadIdx.y + dy][threadIdx.x + dx]));
      }
      outr[((int64_t)z * Y + oy) * X + ox] = from_f32<T>(acc);
    }
    __syncthreads();  // the plane loaded next overwrites one read above
  }
}

template <typename T>
void launch(const void* x, void* out, const void* w, int ranks, int Z, int Y, int X, int tz,
            cudaStream_t stream) {
  const int zchunks = (Z + tz - 1) / tz;
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, ranks * zchunks);
  dim3 block(TX, TY);
  stencil27_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(w),
      Z, Y, X, tz, zchunks);
}

}  // namespace

extern "C" {

// out[r] (Z, Y, X) = 27-point stencil of x[r] (Z+2, Y+2, X+2), r < ranks;
// both contiguous, w is 27 contiguous f32 in (dz, dy, dx) order.  `tz` is
// the z-extent one block marches; ranks * ceil(Z / tz) must be <= 65535.
int stencil27(const void* x, void* out, const void* w, int dtype, int ranks, int Z, int Y,
              int X, int tz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ranks > 0 && Z > 0 && Y > 0 && X > 0) {
    if (dtype == F32) launch<float>(x, out, w, ranks, Z, Y, X, tz, st);
    else if (dtype == BF16) launch<__nv_bfloat16>(x, out, w, ranks, Z, Y, X, tz, st);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
