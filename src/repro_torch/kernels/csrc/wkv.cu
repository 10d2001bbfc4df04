// RWKV-6 WKV chunk scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _wkv_kernel of src/repro/kernels/wkv/wkv.py
// (wkv_chunked), and runs where the JAX model runs its jnp _wkv_chunk /
// wkv_scan (src/repro/models/rwkv.py).  Per (batch, head) row, with state
// S in R^{hd x hd}, it sweeps T in chunks of c tokens and for each chunk
// computes, in f32:
//   cum      = cumsum_t(lw),  cum_prev = cum - lw            (lw < 0)
//   y_t      = (r_t * exp(cum_prev_t)) . S                    state term
//            + sum_{s<t} A_ts v_s,  A_ts = sum_i r_ti k_si exp(min(cum_prev_ti - cum_si, 0))
//            + (sum_i r_ti u_i k_ti) v_t                      diagonal bonus
//   S       <- diag(exp(cum_T)) S + sum_s (k_s * exp(cum_T - cum_s)) (x) v_s
// starting from a given S0 (zeros when none is given) and writing the final
// state.  Decode is the same kernel at T = c = 1.
//
// What bounds it on this card: operations, and of them the exponentials.
// The pairwise term needs c*c/2*hd expf per chunk and row (at c = hd = 64,
// 131072), beside about 2*c*hd*hd flops of state products; the bytes are
// one read of r, k, v, lw and one write of y.  The design:
//   * the TPU kernel carries S across a sequential ("arbitrary") grid axis
//     in VMEM; here blocks run in no order, so the chunk loop is inside the
//     block and S stays in shared memory for the whole sweep;
//   * the grid is (hd / JT column tiles of S, head, batch).  Column j of S
//     needs only column j of v, so the tiles of one row are independent;
//     at prefill with batch 1 that turns 32 rows into 128 blocks for 132
//     SMs, at the price of every tile recomputing the row's (c, c) A;
//   * A is computed in 4x4 register tiles over the lower triangle only
//     (16 independent exponentials per channel step), the bonus lands on
//     A's diagonal, so y = (r * exp(cum_prev)) . S + A . v in one pass.
//     At c = 64 that is 16 diagonal and 120 off-diagonal tiles; each
//     off-diagonal tile is split over two threads by channel parity (their
//     two partial sums meet in shared memory, a + b in either order), so
//     16 + 240 = 256 items occupy every thread of the block;
//   * a chunk's r, k, lw and v are loaded into registers in one unrolled
//     sweep before they are stored, so the loads are in flight together;
//   * r, k, v, lw are read in the model layout (B, T, H, hd) through
//     (batch, time, head) strides, so the caller makes no transposing copy;
//     u is read per (batch, head) through its own strides, so a per-head
//     (H, hd) u and the JAX kernel's per-row (BH, 1, hd) u both work;
//   * expf (not __expf) keeps f32 within the JAX kernel test's 3e-4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr int NTHREADS = 256;
constexpr int MAX_CHUNK = 64;  // rows of a chunk held in shared memory

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int HD>
struct Tile {
  static constexpr int JT = HD < 16 ? HD : 16;  // state columns per block
  static constexpr int LD = HD + 1;             // padded pitch of the (c, hd) arrays
};

// floats of dynamic shared memory for a chunk of cp4 (c rounded up to 4) rows
template <int HD>
__host__ __device__ constexpr int smem_floats(int cp4) {
  return 4 * cp4 * Tile<HD>::LD + cp4 * (cp4 + 1) + cp4 * Tile<HD>::JT + HD * Tile<HD>::JT +
         3 * HD;
}

// One 4x4 tile of A: rows t0..t0+3, columns s0..s0+3, summed over the
// channels i0, i0 + step, ...  DIAG tiles (t0 == s0, every channel) keep the
// strictly lower entries of the chunk's c rows (padded rows stay zero, so a
// decode step's c = 1 computes the bonus alone), put the bonus on the
// diagonal and zero the rest, and are stored; other tiles lie wholly below
// the diagonal, and their partial sums are added to As (zeroed before).
template <int HD, bool DIAG>
__device__ __forceinline__ void a_tile(const float* Rs, const float* Ks, const float* Cum,
                                       const float* Cp, const float* Us, float* As, int lda,
                                       int t0, int s0, int i0, int step, int c) {
  constexpr int LD = Tile<HD>::LD;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int i = i0; i < HD; i += step) {
    float rv[4], cp[4], kv[4], cs[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rv[a] = Rs[(t0 + a) * LD + i];
      cp[a] = Cp[(t0 + a) * LD + i];
      kv[a] = Ks[(s0 + a) * LD + i];
      cs[a] = Cum[(s0 + a) * LD + i];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (!DIAG)
          acc[a][b] = fmaf(rv[a] * kv[b], expf(fminf(cp[a] - cs[b], 0.f)), acc[a][b]);
        else if (t0 + a < c && b < a)
          acc[a][b] = fmaf(rv[a] * kv[b], expf(fminf(cp[a] - cs[b], 0.f)), acc[a][b]);
        else if (b == a)
          acc[a][b] = fmaf(rv[a] * Us[i], kv[b], acc[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (DIAG)
        As[(t0 + a) * lda + s0 + b] = acc[a][b];
      else
        atomicAdd(&As[(t0 + a) * lda + s0 + b], acc[a][b]);
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ lw, const T* __restrict__ u, const float* __restrict__ S0,
           T* __restrict__ y, float* __restrict__ S_fin, int Tlen, int H, int c, Strides rs,
           Strides ks, Strides vs, Strides ls, long long usb, long long ush) {
  constexpr int JT = Tile<HD>::JT, LD = Tile<HD>::LD, J4 = JT / 4;
  const int cp4 = (c + 3) & ~3;
  const int lda = cp4 + 1;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                 // cp4 x LD: r, then r * exp(cum_prev)
  float* Ks = Rs + cp4 * LD;        // cp4 x LD: k, then k * exp(total - cum)
  float* Cum = Ks + cp4 * LD;       // cp4 x LD: inclusive cumsum of lw
  float* Cp = Cum + cp4 * LD;       // cp4 x LD: lw, then cum - lw
  float* As = Cp + cp4 * LD;        // cp4 x lda: A, bonus on the diagonal
  float* Vs = As + cp4 * lda;       // cp4 x JT: this block's columns of v
  float* Ss = Vs + cp4 * JT;        // HD x JT: this block's columns of S
  float* Us = Ss + HD * JT;         // HD: bonus u of this head
  float* Tot = Us + HD;             // HD: cum at the chunk's last row
  float* Dec = Tot + HD;            // HD: exp(Tot)

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * JT, h = blockIdx.y, b = blockIdx.z;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h + j0;
  const T* lb = lw + b * ls.b + h * ls.h;
  const long long ys = (long long)H * HD;  // y is (B, T, H, HD), contiguous
  T* yb = y + (long long)b * Tlen * ys + h * HD + j0;
  const long long srow = ((long long)b * H + h) * HD * HD + j0;  // S[b, h, 0, j0]

  for (int i = tid; i < HD; i += NTHREADS) Us[i] = to_f32(u[b * usb + h * ush + i]);
  for (int e = tid; e < HD * JT; e += NTHREADS) {
    const int i = e / JT, jj = e % JT;
    Ss[e] = S0 ? S0[srow + (long long)i * HD + jj] : 0.f;
  }

  // A's work items: nt diagonal tiles, then each off-diagonal tile twice
  // (even and odd channels)
  const int nt = cp4 / 4, items = nt + nt * (nt - 1);
  constexpr int QL = (MAX_CHUNK * HD + NTHREADS - 1) / NTHREADS;  // loads a thread
  constexpr int QV = (MAX_CHUNK * JT + NTHREADS - 1) / NTHREADS;
  for (int t0 = 0; t0 < Tlen; t0 += c) {
    __syncthreads();  // the previous chunk no longer reads the chunk arrays
    float rr[QL], kk[QL], ll[QL], vv[QV];
#pragma unroll
    for (int q = 0; q < QL; ++q) {
      const int e = tid + q * NTHREADS, t = e / HD, i = e % HD;
      const bool ok = e < cp4 * HD && t < c;
      const long long tt = t0 + t;
      rr[q] = ok ? to_f32(rb[tt * rs.t + i]) : 0.f;
      kk[q] = ok ? to_f32(kb[tt * ks.t + i]) : 0.f;
      ll[q] = ok ? to_f32(lb[tt * ls.t + i]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      const int e = tid + q * NTHREADS, t = e / JT, jj = e % JT;
      vv[q] = e < cp4 * JT && t < c ? to_f32(vb[(long long)(t0 + t) * vs.t + jj]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < QL; ++q) {
      const int e = tid + q * NTHREADS, t = e / HD, i = e % HD;
      if (e < cp4 * HD) {
        Rs[t * LD + i] = rr[q];
        Ks[t * LD + i] = kk[q];
        Cp[t * LD + i] = ll[q];
      }
    }
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      const int e = tid + q * NTHREADS;
      if (e < cp4 * JT) Vs[e] = vv[q];
    }
    for (int e = tid; e < cp4 * lda; e += NTHREADS) As[e] = 0.f;
    __syncthreads();

    // cumsum over the chunk, one thread per channel, in order
    for (int i = tid; i < HD; i += NTHREADS) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        const float l = Cp[t * LD + i];
        acc += l;
        Cum[t * LD + i] = acc;
        Cp[t * LD + i] = acc - l;
      }
      for (int t = c; t < cp4; ++t) Cum[t * LD + i] = 0.f;
      Tot[i] = acc;
      Dec[i] = expf(acc);
    }
    __syncthreads();

    // A over the lower triangle of 4x4 tiles (padded rows hold zeros)
    for (int p = tid; p < items; p += NTHREADS) {
      if (p < nt) {
        a_tile<HD, true>(Rs, Ks, Cum, Cp, Us, As, lda, 4 * p, 4 * p, 0, 1, c);
        continue;
      }
      // off-diagonal tile o = (ti, si), ti > si, rows in order
      const int o = (p - nt) >> 1, half = (p - nt) & 1;
      int ti = (int)((1.f + sqrtf(1.f + 8.f * o)) * 0.5f);
      while (ti * (ti - 1) / 2 > o) --ti;
      while ((ti + 1) * ti / 2 <= o) ++ti;
      const int si = o - ti * (ti - 1) / 2;
      a_tile<HD, false>(Rs, Ks, Cum, Cp, Us, As, lda, 4 * ti, 4 * si, half, 2, c);
    }
    __syncthreads();

    // decay r and k in place: r * exp(cum_prev), k * exp(total - cum)
    for (int e = tid; e < c * HD; e += NTHREADS) {
      const int t = e / HD, i = e % HD;
      Rs[t * LD + i] *= expf(Cp[t * LD + i]);
      Ks[t * LD + i] *= expf(Tot[i] - Cum[t * LD + i]);
    }
    __syncthreads();

    // y: four columns a thread, state term then the intra-chunk + bonus term
    for (int e = tid; e < c * J4; e += NTHREADS) {
      const int t = e / J4, q = e % J4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* rrow = Rs + t * LD;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) {
        const float rv = rrow[i];
        const float4 s4 = reinterpret_cast<const float4*>(Ss + i * JT)[q];
        acc.x = fmaf(rv, s4.x, acc.x);
        acc.y = fmaf(rv, s4.y, acc.y);
        acc.z = fmaf(rv, s4.z, acc.z);
        acc.w = fmaf(rv, s4.w, acc.w);
      }
      const float* arow = As + t * lda;
      for (int s = 0; s <= t; ++s) {
        const float av = arow[s];
        const float4 v4 = reinterpret_cast<const float4*>(Vs + s * JT)[q];
        acc.x = fmaf(av, v4.x, acc.x);
        acc.y = fmaf(av, v4.y, acc.y);
        acc.z = fmaf(av, v4.z, acc.z);
        acc.w = fmaf(av, v4.w, acc.w);
      }
      T* yrow = yb + (long long)(t0 + t) * ys + 4 * q;
      yrow[0] = from_f32<T>(acc.x);
      yrow[1] = from_f32<T>(acc.y);
      yrow[2] = from_f32<T>(acc.z);
      yrow[3] = from_f32<T>(acc.w);
    }
    __syncthreads();  // y has read S

    // S <- diag(exp(total)) S + sum_s k_dec_s (x) v_s
    for (int e = tid; e < HD * J4; e += NTHREADS) {
      const int i = e / J4, q = e % J4;
      float4 s4 = reinterpret_cast<float4*>(Ss + i * JT)[q];
      const float dec = Dec[i];
      s4.x *= dec;
      s4.y *= dec;
      s4.z *= dec;
      s4.w *= dec;
      for (int s = 0; s < c; ++s) {
        const float kd = Ks[s * LD + i];
        const float4 v4 = reinterpret_cast<const float4*>(Vs + s * JT)[q];
        s4.x = fmaf(kd, v4.x, s4.x);
        s4.y = fmaf(kd, v4.y, s4.y);
        s4.z = fmaf(kd, v4.z, s4.z);
        s4.w = fmaf(kd, v4.w, s4.w);
      }
      reinterpret_cast<float4*>(Ss + i * JT)[q] = s4;
    }
  }
  __syncthreads();
  for (int e = tid; e < HD * JT; e += NTHREADS) {
    const int i = e / JT, jj = e % JT;
    S_fin[srow + (long long)i * HD + jj] = Ss[e];
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
                   const float* S0, void* y, float* S_fin, int B, int Tlen, int H, int c,
                   Strides rs, Strides ks, Strides vs, Strides ls, long long usb, long long ush,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<HD>((c + 3) & ~3) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats<HD>(MAX_CHUNK) * sizeof(float)));
  if (err != cudaSuccess) return err;
  dim3 grid(HD / Tile<HD>::JT, H, B);
  wkv_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), static_cast<const T*>(u), S0, static_cast<T*>(y), S_fin, Tlen,
      H, c, rs, ks, vs, ls, usb, ush);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* r, const void* k, const void* v, const void* lw,
                      const void* u, const float* S0, void* y, float* S_fin, int B, int Tlen,
                      int H, int c, Strides rs, Strides ks, Strides vs, Strides ls,
                      long long usb, long long ush, cudaStream_t st) {
  switch (HD) {
    case 8:
      return launch<T, 8>(r, k, v, lw, u, S0, y, S_fin, B, Tlen, H, c, rs, ks, vs, ls, usb, ush, st);
    case 16:
      return launch<T, 16>(r, k, v, lw, u, S0, y, S_fin, B, Tlen, H, c, rs, ks, vs, ls, usb, ush, st);
    case 32:
      return launch<T, 32>(r, k, v, lw, u, S0, y, S_fin, B, Tlen, H, c, rs, ks, vs, ls, usb, ush, st);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, S0, y, S_fin, B, Tlen, H, c, rs, ks, vs, ls, usb, ush, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y (B, T, H, hd) contiguous, in the inputs' dtype, and S_fin (B, H, hd, hd)
// f32 contiguous, from r, k, v, lw addressed as base + b*sb + t*st + h*sh + i
// (element strides, i contiguous), u as base + b*usb + h*ush + i, and S0
// (B, H, hd, hd) f32 contiguous or null for zeros.  hd is 8, 16, 32 or 64;
// c divides T and is at most 64; H, B <= 65535.
int wkv_chunked(const void* r, const void* k, const void* v, const void* lw, const void* u,
                const void* S0, void* y, void* S_fin, int dtype, int B, int T, int H, int hd,
                int c, long long rsb, long long rst, long long rsh, long long ksb, long long kst,
                long long ksh, long long vsb, long long vst, long long vsh, long long lsb,
                long long lst, long long lsh, long long usb, long long ush, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 0 || c > MAX_CHUNK || T % c != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaGetLastError();
  const Strides rs{rsb, rst, rsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh}, ls{lsb, lst, lsh};
  const float* s0 = static_cast<const float*>(S0);
  float* sf = static_cast<float*>(S_fin);
  cudaError_t err;
  if (dtype == F32)
    err = launch_hd<float>(hd, r, k, v, lw, u, s0, y, sf, B, T, H, c, rs, ks, vs, ls, usb, ush, st);
  else if (dtype == BF16)
    err = launch_hd<__nv_bfloat16>(hd, r, k, v, lw, u, s0, y, sf, B, T, H, c, rs, ks, vs, ls, usb,
                                   ush, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
