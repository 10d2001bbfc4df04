// 27-point stencil update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _stencil_kernel of
// src/repro/kernels/stencil27/stencil27.py (stencil27): every interior
// cell of a ghosted (Z+2, Y+2, X+2) block becomes the weighted sum of its
// 3x3x3 neighbourhood, accumulated in f32 in dz -> dy -> dx order and
// stored in the input type.  Here one launch covers a batch of R blocks
// (all stacked ranks at once), and the output is written through its four
// strides, so the caller can hand in the interior window of the block the
// result belongs in (no second write of the interior).
//
// What bounds it on this card: bytes.  27 weighted terms per cell against
// 4 + 4 bytes (f32) of compulsory traffic is ~7 flop/byte, below the ~20
// flop/byte at which the 67 TFLOP/s f32 pipes would become the limit, so
// the least time is (input + output bytes) / 3.35 TB/s.  The design:
//   * A block owns a TX x TY = 32 x 64 column of outputs and marches up z
//     through all of it (or through a chunk of Z where the card would
//     otherwise hold too few blocks), so each input plane is read from
//     device memory about once: (34 * 66) / (32 * 64) = 1.10x for the rim,
//     (zc + 2) / zc in z.
//   * Planes arrive through a ring of NS = 4 shared-memory buffers filled by
//     cp.async (8 bytes: two f32 or two bf16 at 4 bytes, where the rows are
//     aligned to a pair; else one element), so three planes are in flight
//     while one is computed, with one __syncthreads a plane.  A tensor map
//     (TMA) would need 16-byte row strides, which the x-wrapped block (514
//     elements a row) does not have.
//   * Register blocking: each thread holds a column of RY = 8 outputs along
//     y for three output planes at once.  A plane that arrives adds its
//     dz = 2 terms to the outputs of plane z-2 (which are then stored), its
//     dz = 1 terms to those of z-1 and starts z with its dz = 0 terms.
//     Planes arrive in increasing z, so every output still adds its terms
//     in the reference's dz -> dy -> dx order.  A thread reads (RY+2) x 3
//     values of each plane from shared memory for 8 x 27 terms: 3.75 shared
//     loads an output instead of 27.
//   * The shape was chosen on the card (H100, heat3d f32): 8 warps of 8 rows
//     a thread and 4 stages took 1.69-1.72 ms, against 2.04-2.08 for 4
//     warps, 1.73-1.79 for 4, 6 or 16 rows a thread and 1.71-1.72 for 5
//     stages.
//   * Ragged edges are masked, so any Z, Y, X >= 1 works, including the
//     thin 3-cell shells of the overlap schedule; ranks and z chunks share
//     the grid's z, walked in a loop past CUDA's 65535.
//
// Numerics: each term is w*x rounded, then added rounded
// (__fmul_rn/__fadd_rn), in the reference's order: no FMA contraction, so
// the kernel matches its plain PyTorch version (separate mul and add per
// term) to the bit on finite inputs; the stated tolerance still allows for
// FMA-level differences.  FMA would not pay in f32, which is bound by
// bytes (1.76 ms with it); it would in bf16, half the bytes for the same
// instructions (1.36-1.38 ms against 1.78-1.79).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr int TX = 32;          // outputs along x: one warp's lanes
constexpr int RY = 8;           // outputs along y one thread holds
constexpr int WARPS = 8;
constexpr int TY = WARPS * RY;  // outputs along y of a block
constexpr int PX = TX + 2;      // a plane tile's row, rim included
constexpr int PY = TY + 2;
constexpr int NS = 4;           // planes in the shared-memory ring
constexpr int THREADS = TX * WARPS;

struct Strides { int64_t r, z, y, x; };  // the output's, in elements

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? BYTES : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
               "n"(BYTES), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the (dz) terms of one plane into a column of RY outputs, dy -> dx order
template <int DZ, bool START>
__device__ __forceinline__ void accumulate(float (&acc)[RY], const float (&v)[RY + 2][3],
                                           const float (&w)[27]) {
#pragma unroll
  for (int i = 0; i < RY; ++i) {
    if (START) acc[i] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(w[DZ * 9 + dy * 3 + dx], v[i + dy][dx]));
  }
}

// E elements a copy: E * sizeof(T) bytes by cp.async where that is 4 or 8,
// else (one bf16) a plain load and shared store.
template <typename T, int E>
struct PlaneLoader {
  static constexpr int ROW = PX / E;  // copies a tile row
  static constexpr int ITEMS = (PY * ROW + THREADS - 1) / THREADS;
  int goff[ITEMS];   // element offset in the plane, -1: outside the block
  int soff[ITEMS];   // element offset in a ring buffer, -1: no item

  __device__ void init(int tid, int x0, int y0, int Y, int X) {
    const int sy = X + 2;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = tid + q * THREADS;
      const int ly = i / ROW, lx = (i - ly * ROW) * E;
      const int gy = y0 + ly, gx = x0 + lx;
      soff[q] = i < PY * ROW ? ly * PX + lx : -1;
      goff[q] = gy < Y + 2 && gx < X + 2 ? gy * sy + gx : -1;
    }
  }
  __device__ __forceinline__ void load(T* buf, const T* plane) const {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (soff[q] < 0) continue;
      const bool ok = goff[q] >= 0;
      const T* src = plane + (ok ? goff[q] : 0);
      if constexpr (E * sizeof(T) >= 4) {
        cp_async<E * sizeof(T)>(buf + soff[q], src, ok);
      } else {
        buf[soff[q]] = ok ? *src : from_f32<T>(0.f);
      }
    }
  }
};

template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
stencil27_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ wg,
                 int R, int Z, int Y, int X, int zc, int zchunks, Strides os) {
  __shared__ __align__(16) unsigned char ring_bytes[NS * PY * PX * sizeof(T)];
  T (*ring)[PY * PX] = reinterpret_cast<T (*)[PY * PX]>(ring_bytes);
  float w[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) w[i] = wg[i];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int64_t sz = (int64_t)(Y + 2) * (X + 2);
  const int ox = x0 + lane, oy = y0 + warp * RY;  // this thread's column
  PlaneLoader<T, E> loader;
  loader.init(tid, x0, y0, Y, X);

  const int64_t jobs = (int64_t)R * zchunks;
  for (int64_t job = blockIdx.z; job < jobs; job += gridDim.z) {
    const int r = (int)(job / zchunks);
    const int z0 = (int)(job - (int64_t)r * zchunks) * zc;
    const int nz = min(zc, Z - z0);  // outputs z0 .. z0+nz-1 read planes z0 .. z0+nz+1
    const int np = nz + 2;
    const T* xr = x + ((int64_t)r * (Z + 2) + z0) * sz;
    T* outr = out + r * os.r + (int64_t)z0 * os.z + (int64_t)oy * os.y + ox * os.x;

#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < np) loader.load(ring[s], xr + s * sz);
      cp_async_commit();
    }
    float a[RY], b[RY], c[RY];
    // plane k: finishes outputs k-2 (fin), adds to k-1 (mid), starts k (beg)
    auto step = [&](int k, float (&fin)[RY], float (&mid)[RY], float (&beg)[RY]) {
      cp_async_wait<NS - 2>();  // plane k is in this thread's copies
      __syncthreads();          // ... and in everyone's; plane k-1 is read
      if (k + NS - 1 < np) loader.load(ring[(k + NS - 1) % NS], xr + (k + NS - 1) * sz);
      cp_async_commit();
      float v[RY + 2][3];
      const T* p = ring[k % NS] + warp * RY * PX + lane;
#pragma unroll
      for (int j = 0; j < RY + 2; ++j)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[j][dx] = to_f32(p[j * PX + dx]);
      if (k >= 2) {
        accumulate<2, false>(fin, v, w);
        if (ox < X) {
          T* o = outr + (int64_t)(k - 2) * os.z;
#pragma unroll
          for (int i = 0; i < RY; ++i)
            if (oy + i < Y) o[i * os.y] = from_f32<T>(fin[i]);
        }
      }
      if (k >= 1 && k <= nz) accumulate<1, false>(mid, v, w);
      if (k < nz) accumulate<0, true>(beg, v, w);
    };
    for (int k = 0; k < np; k += 3) {
      step(k, a, b, c);
      if (k + 1 < np) step(k + 1, b, c, a);
      if (k + 2 < np) step(k + 2, c, a, b);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next job refills the ring
  }
}

template <typename T, int E>
void launch(const void* x, void* out, const void* w, int ranks, int Z, int Y, int X, int zc,
            int grid_z, const Strides& os, cudaStream_t stream) {
  const int zchunks = (Z + zc - 1) / zc;
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, grid_z);
  stencil27_kernel<T, E><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(w),
      ranks, Z, Y, X, zc, zchunks, os);
}

}  // namespace

extern "C" {

// out[r] (Z, Y, X) = 27-point stencil of x[r] (Z+2, Y+2, X+2), r < ranks;
// x contiguous, out through its strides (rank, z, y, x in elements), w 27
// contiguous f32 in (dz, dy, dx) order.  One block marches `zc` output
// planes; grid_z (<= 65535) blocks walk the ranks * ceil(Z / zc) marches.
// pair: two elements a copy (x 2-element aligned, X + 2 even).
int stencil27(const void* x, void* out, const void* w, int dtype, int ranks, int Z, int Y,
              int X, int zc, int grid_z, int64_t os_r, int64_t os_z, int64_t os_y,
              int64_t os_x, int pair, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ranks <= 0 || Z <= 0 || Y <= 0 || X <= 0) return (int)cudaGetLastError();
  const Strides os = {os_r, os_z, os_y, os_x};
  const size_t esize = dtype == F32 ? 4 : 2;
  if (pair && (reinterpret_cast<uintptr_t>(x) % (2 * esize) || (X + 2) % 2))
    return (int)cudaErrorMisalignedAddress;
  if (dtype == F32) {
    if (pair) launch<float, 2>(x, out, w, ranks, Z, Y, X, zc, grid_z, os, st);
    else launch<float, 1>(x, out, w, ranks, Z, Y, X, zc, grid_z, os, st);
  } else if (dtype == BF16) {
    if (pair) launch<__nv_bfloat16, 2>(x, out, w, ranks, Z, Y, X, zc, grid_z, os, st);
    else launch<__nv_bfloat16, 1>(x, out, w, ranks, Z, Y, X, zc, grid_z, os, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
