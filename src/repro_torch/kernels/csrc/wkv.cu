// RWKV-6 WKV chunk scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _wkv_kernel of src/repro/kernels/wkv/wkv.py
// (wkv_chunked), and runs where the JAX model runs its jnp _wkv_chunk /
// wkv_scan (src/repro/models/rwkv.py).  Per (batch, head) row, with state
// S in R^{hd x hd}, it sweeps T in chunks of c tokens and for each chunk
// computes, in f32:
//   cum      = cumsum_t(lw),  cum_prev = cum - lw            (lw < 0)
//   y_t      = (r_t * exp(cum_prev_t)) . S                    state term
//            + sum_{s<t} A_ts v_s,  A_ts = sum_i r_ti k_si exp(cum_prev_ti - cum_si)
//            + (sum_i r_ti u_i k_ti) v_t                      diagonal bonus
//   S       <- diag(exp(cum_T)) S + sum_s (k_s * exp(cum_T - cum_s)) (x) v_s
// starting from a given S0 (zeros when none is given) and writing the final
// state; for training it also writes each chunk's entry state, which the
// backward below reads.
//
// What bounds it on this card: shared-memory traffic and latency at 8
// warps an SM, not a roofline (operations bound it there: about 4*c*hd*hd
// flops of state products a chunk, and the bytes are one read of r, k, v,
// lw and one write of y).  Taken per (t, s, channel), the pairwise term
// would cost c*c/2*hd exponentials a chunk (131072 at c = hd = 64), in
// each of a head's column tiles.  A 64-row chunk is now three dependent
// phases (the prep; y beside the state update; the next chunk's A), each
// reading its operands from shared memory.  The design:
//   * factored sub-block decays.  A chunk is cut into sub-blocks of 16 rows
//     (a ragged chunk is padded with r = k = v = lw = 0, which leaves every
//     cumulative sum unchanged).  With cumulative sums taken inside each
//     sub-block (Cl inclusive, Cp exclusive, tot the sub-block's sum), a
//     source row s of sub-block q and a target row t of sub-block p > q give
//       cum_prev_t - cum_s = Cp_t + (tot_{q+1} + .. + tot_{p-1}) + (tot_q - Cl_s)
//     three sums of log decays, each <= 0, so
//       A_pq = (r_p * e^{Cp}) . diag(e^{b_{p-1} - b_q}) . (k_q * e^{tot_q - Cl})^T
//     is a small dense product (4 x 4 tiles).  Only the diagonal
//     sub-blocks take a per-pair exponential, exp(min(Cp_t - Cl_s, 0)), in
//     1 x 4 strips of their lower triangle.  No exponent is ever positive,
//     and every factor is at least the exact term, so a factor underflows
//     only where the term itself is below f32's range.  The state term and
//     update reuse the factors: r * e^{cum_prev} = (r * e^{Cp}) * e^{b_{p-1}},
//     k * e^{cum_T - cum} = (k * e^{tot - Cl}) * e^{cum_T - b_q}.  The
//     exclusive sums are the running sums before each row is added, so
//     consecutive rows' decay is exactly 1 (the plain version's cum - lw
//     is off by ulps of the 64-row sum, 2.4e-4 at the clamp's -exp(4)).
//   * one A per cluster.  The grid is (hd / JT column tiles of S, head,
//     batch); column j of S needs only column j of v, so the tiles of a head
//     are independent but for A.  Pairs of them (CL = 2; 1 where a head is
//     one CTA) run as one thread-block cluster: each CTA computes every
//     other item of A (at c = 64, two diagonal sub-blocks' 40 strips each
//     and half of the 96 off-diagonal tiles) and stores it into both CTAs'
//     copies of A through distributed shared memory; one cluster barrier a
//     chunk publishes A, and A is double-buffered, so the next chunk's
//     stores cannot overtake a slower CTA's reads.  rwkv6-1.6b's 32 heads at
//     batch 1 are 128 CTAs for 132 SMs, one wave.  Clusters of four (A once
//     a head) would take two waves there: an H100 holds 30 clusters of four
//     such CTAs but 66 of two.  A CTA alone (A computed by every CTA of a
//     head) measured 1.4x slower than pairs, and no longer fits the
//     pipelined shared memory.
//   * a pipelined march, two barriers a chunk.  A needs only its chunk's
//     prep, not the state, so it runs one chunk ahead: in one phase warps
//     0-3 compute y of chunk n and warps 4-7 update the state (into the
//     other buffer of S), then every thread takes its items of A for chunk
//     n + 1, while chunk n + 2's raw r, k, lw and the CTA's columns of v
//     are copied by cp.async (16 bytes a copy where the rows are aligned,
//     plain loads otherwise) into the staging area; the cluster barrier
//     ends it (A published, S whole, the staging visible after each
//     thread's cp.async wait).  In the second phase every thread preps
//     chunk n + 2 (staging into f32 working rows and decay factors, kept
//     in two sets by chunk parity), and a CTA barrier ends it.  Every CTA
//     of a cluster loads r, k, lw itself (from L2 after the first), and no
//     TMA descriptor is built per call (one bulk copy a row and array,
//     cp.async.bulk from one warp, made the kernel 1.7x slower: the 256
//     small copies a chunk queue in the copy engine).
//   * the prep gives each (channel, sub-block) one thread that walks its
//     16 rows; the four sub-blocks of a channel sit in adjacent lanes and
//     trade their sums by shuffles, so the decay factors between
//     sub-blocks need no barrier.  A's items come from a list built once
//     per launch (no index arithmetic in the loop), each split over NQ
//     lanes by channel and summed by shuffles (no atomics); strips are
//     branch-free (an entry on or above the diagonal gets exponent -inf).
//   * a decode route, chosen by c == 1: one CTA per (head, batch) holds S
//     in registers for all T tokens, reads and writes it in 16-byte
//     vectors, and does y = r.S + (r.u.k) v and S <- diag(e^lw) S + k (x) v
//     with no chunk machinery.
//   * cudaFuncSetAttribute runs once per kernel instance and device, not
//     per launch.
//   * r, k, v, lw are read in the model layout (B, T, H, hd) through
//     (batch, time, head) strides, so the caller makes no transposing copy;
//     u is read per (batch, head) through its own strides, so a per-head
//     (H, hd) u and the JAX kernel's per-row (BH, 1, hd) u both work.
//   * arithmetic is f32 on the CUDA cores: a TF32 product would round each
//     term at about 5e-4, above the stated 3e-4.  The sums of log decays
//     are kept in log2 units and exponentiated by ex2.approx.ftz (relative
//     error about 2^-22, as expf's; results below 2^-126, terms far below
//     the tolerance, flush to 0).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr int NTHREADS = 256;   // chunked route
constexpr int NTHREADS_D = 128; // decode route
constexpr int MAX_CHUNK = 64;   // rows of a chunk held in shared memory
constexpr int SB = 16;          // rows of a sub-block
constexpr int MAX_SB = MAX_CHUNK / SB;
constexpr int NQ = 4;           // lanes that split one item of A by channel
constexpr int MAX_ITEMS = MAX_SB * 40 + MAX_SB * (MAX_SB - 1) / 2 * 16;  // 256
constexpr float LOG2E = 1.4426950408889634f;

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

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 a) {
  p[0] = from_f32<T>(a.x);
  p[1] = from_f32<T>(a.y);
  p[2] = from_f32<T>(a.z);
  p[3] = from_f32<T>(a.w);
}
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;  // y rows and column tiles are 16-byte aligned
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// 2^x by the SFU (ex2.approx.ftz: relative error about 2^-22, results
// below 2^-126 flushed to 0); every x here is <= 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int HD>
struct Tile {
  static constexpr int JT = HD < 16 ? HD : 16;  // state columns per CTA
  static constexpr int NC = HD / JT;            // CTAs a head
  static constexpr int LD = HD + 1;             // pitch of the f32 working arrays
  static constexpr int LDA = MAX_CHUNK + 4;     // pitch of A (16-byte rows)
};

// Shared memory of the chunked route with clusters of CL CTAs, in bytes
// from the base, for a chunk padded to cp rows (a multiple of 16).
// Staging holds raw inputs of type T; each sub-block of its rows starts
// 32 bytes further on (a bank skew: the prep reads four sub-blocks at once).
// The prep's results for y and the state update (Rq, Kq, V and the decay
// factors) come in two sets, by chunk parity: y and the state update of
// chunk n read one set while A of chunk n + 1 reads the other.
template <typename T, int HD, int CL>
struct Layout {
  static constexpr int JT = Tile<HD>::JT, LD = Tile<HD>::LD, LDA = Tile<HD>::LDA;
  static constexpr int PT = HD + 16 / (int)sizeof(T);  // staging pitch, 16-byte rows
  static constexpr int SKEW = 32 / (int)sizeof(T);
  static constexpr int ND = (MAX_SB + CL - 1) / CL;    // diagonal sub-blocks a CTA computes
  __host__ __device__ static int row(int t) { return t * PT + (t / SB) * SKEW; }
  size_t st_r, st_k, st_l, st_v;   // staging: r, k, lw (row(t)), v (cp x JT)
  size_t set, set_bytes;           // two sets of the following, offsets within a set:
  size_t Rq, Kq, V;                //   all rows: r 2^Cp, k 2^{tot - Cl}; v's columns
  size_t E, F, G, ET;              //   2^{b_{p-1}}, 2^{cum_T - b_p}, 2^{b_{p-1} - b_q}, 2^{cum_T}
  size_t R, K, Cl, Cp;             // the rows of this CTA's diagonal sub-blocks
  size_t A, S;                     // A: 2 x (MAX_CHUNK x LDA); S: 2 x (HD x JT)
  size_t U, items, total;
  __host__ __device__ explicit Layout(int cp) {
    size_t o = 0;
    auto take = [&o](size_t bytes) {
      const size_t at = o;
      o += (bytes + 15) & ~size_t(15);
      return at;
    };
    const size_t st = sizeof(T) * (cp * PT + MAX_SB * SKEW);
    st_r = take(st);
    st_k = take(st);
    st_l = take(st);
    st_v = take(sizeof(T) * cp * JT);
    const size_t base = o;
    o = 0;
    Rq = take(4 * cp * LD);
    Kq = take(4 * cp * LD);
    V = take(4 * cp * JT);
    E = take(4 * MAX_SB * HD);
    F = take(4 * MAX_SB * HD);
    G = take(4 * MAX_SB * MAX_SB * HD);
    ET = take(4 * HD);
    set_bytes = o;
    set = base;
    o = base + 2 * set_bytes;
    R = take(4 * ND * SB * LD);
    K = take(4 * ND * SB * LD);
    Cl = take(4 * ND * SB * LD);
    Cp = take(4 * ND * SB * LD);
    A = take(4 * 2 * MAX_CHUNK * LDA);
    S = take(4 * 2 * HD * JT);
    U = take(4 * HD);
    items = take(2 * MAX_ITEMS);
    total = o;
  }
};

// Copy rows [t0, t0 + c) of r, k, lw and the CTA's columns of v into the
// staging area: cp.async of 16 bytes where every row is 16-byte aligned
// (vec), plain loads and stores otherwise.  Rows c..cp-1 stay zero.
template <typename T, int HD, int CL>
__device__ __forceinline__ void load_chunk(T* Sr, T* Sk, T* Sl, T* Sv, const T* rb,
                                           const T* kb, const T* lb, const T* vb,
                                           const Strides& rs, const Strides& ks,
                                           const Strides& ls, const Strides& vs, long long t0,
                                           int c, bool vec, int tid) {
  using L = Layout<T, HD, CL>;
  constexpr int JT = Tile<HD>::JT;
  if (vec) {
    constexpr int EP = 16 / (int)sizeof(T);  // elements a copy
    constexpr int PR = HD / EP, PV = JT / EP;
    for (int e = tid; e < c * PR; e += NTHREADS) {
      const int t = e / PR, o = (e % PR) * EP, d = L::row(t) + o;
      const long long tt = t0 + t;
      cp_async16(Sr + d, rb + tt * rs.t + o);
      cp_async16(Sk + d, kb + tt * ks.t + o);
      cp_async16(Sl + d, lb + tt * ls.t + o);
    }
    for (int e = tid; e < c * PV; e += NTHREADS) {
      const int t = e / PV, o = (e % PV) * EP;
      cp_async16(Sv + t * JT + o, vb + (t0 + t) * vs.t + o);
    }
  } else {
    for (int e = tid; e < c * HD; e += NTHREADS) {
      const int t = e / HD, i = e % HD, d = L::row(t) + i;
      const long long tt = t0 + t;
      Sr[d] = rb[tt * rs.t + i];
      Sk[d] = kb[tt * ks.t + i];
      Sl[d] = lb[tt * ls.t + i];
    }
    for (int e = tid; e < c * JT; e += NTHREADS) {
      const int t = e / JT, jj = e % JT;
      Sv[t * JT + jj] = vb[(t0 + t) * vs.t + jj];
    }
  }
  cp_async_commit();
}

// A work item of the A phase, split over NQ lanes by channel:
//   kind 0, a 4 x 4 tile of an off-diagonal sub-block (p, q): target rows
//     row..row+3, source rows 4*s4.., G index p*MAX_SB + q in the top bits;
//   kind 1, a 1 x 4 strip of a diagonal sub-block: target row `row`,
//     source rows 4*s4.., the sub-block's slot among this CTA's diagonal
//     sub-blocks in the top bits.
__device__ __forceinline__ uint16_t item_code(int row, int s4, int kind, int top) {
  return (uint16_t)(row | (s4 << 6) | (kind << 10) | (top << 12));
}

// The items of A this CTA computes, diagonal strips first: the diagonal
// sub-blocks p = rank, rank + cl, .. (each 40 strips of its lower
// triangle), then every cl-th tile of the off-diagonal sub-blocks.
__device__ int build_items(uint16_t* items, int nsb, int rank, int cl) {
  int n = 0;
  for (int p = rank; p < nsb; p += cl)
    for (int t = 0; t < SB; ++t)
      for (int s4 = 0; s4 <= t / 4; ++s4)
        items[n++] = item_code(SB * p + t, (SB * p) / 4 + s4, 1, p / cl);
  int g = 0;
  for (int p = 1; p < nsb; ++p)
    for (int q = 0; q < p; ++q)
      for (int ti = 0; ti < 4; ++ti)
        for (int si = 0; si < 4; ++si, ++g)
          if (g % cl == rank) items[n++] = item_code(SB * p + 4 * ti, 4 * q + si, 0, p * MAX_SB + q);
  return n;
}

template <typename T, int HD, int CL>
__global__ void __launch_bounds__(NTHREADS)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ lw, const T* __restrict__ u, const float* __restrict__ S0,
                 T* __restrict__ y, float* __restrict__ S_fin, float* __restrict__ states,
                 int Tlen, int H, int c, Strides rs, Strides ks, Strides vs, Strides ls,
                 long long usb, long long ush, int vec) {
  using L = Layout<T, HD, CL>;
  constexpr int JT = Tile<HD>::JT, LD = Tile<HD>::LD, LDA = Tile<HD>::LDA, J4 = JT / 4;
  static_assert(NQ == 4 && NTHREADS % 32 == 0, "a tile's four rows are stored by its four lanes");
  constexpr unsigned FULL = 0xffffffffu;
  const int cp = (c + SB - 1) / SB * SB, nsb = cp / SB;
  const L lay(cp);
  extern __shared__ __align__(16) unsigned char smem[];
  T* Sr = reinterpret_cast<T*>(smem + lay.st_r);
  T* Sk = reinterpret_cast<T*>(smem + lay.st_k);
  T* Sl = reinterpret_cast<T*>(smem + lay.st_l);
  T* Sv = reinterpret_cast<T*>(smem + lay.st_v);
  float* R = reinterpret_cast<float*>(smem + lay.R);    // r, k, Cl, Cp of the diagonal
  float* K = reinterpret_cast<float*>(smem + lay.K);    // sub-blocks this CTA computes
  float* Cl = reinterpret_cast<float*>(smem + lay.Cl);  // inclusive sum of lw*log2(e) in the sub-block
  float* Cp = reinterpret_cast<float*>(smem + lay.Cp);  // exclusive sum
  float* A = reinterpret_cast<float*>(smem + lay.A);    // 2 x A, bonus on the diagonal
  float* Sb = reinterpret_cast<float*>(smem + lay.S);   // 2 x this CTA's columns of S
  float* Us = reinterpret_cast<float*>(smem + lay.U);
  uint16_t* items = reinterpret_cast<uint16_t*>(smem + lay.items);
  __shared__ int nitems_s;
  // the parity set's arrays
  auto set_f = [&](int par, size_t off) {
    return reinterpret_cast<float*>(smem + lay.set + par * lay.set_bytes + off);
  };

  const int tid = threadIdx.x, lane = tid % 32;
  const int j0 = blockIdx.x * JT, h = blockIdx.y, b = blockIdx.z;
  int rank = 0;
  float* Adst[CL];  // every copy of A this CTA stores into, its own first
  Adst[0] = A;
  if constexpr (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
#pragma unroll
    for (int q = 1; q < CL; ++q) Adst[q] = cluster.map_shared_rank(A, (rank + q) % CL);
  }
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* lb = lw + b * ls.b + h * ls.h;
  const T* vb = v + b * vs.b + h * vs.h + j0;
  const long long ys = (long long)H * HD;  // y is (B, T, H, HD), contiguous
  T* yb = y + (long long)b * Tlen * ys + h * HD + j0;
  const long long srow = ((long long)b * H + h) * HD * HD + j0;  // S[b, h, 0, j0]

  // prep of the staged chunk into set `par`: lane group (channel i,
  // sub-block p = lane % 4) walks its 16 rows, trades sub-block sums by
  // shuffles, writes the decay factors and the f32 working rows; all sums
  // in log2 units
  auto prep = [&](int par) {
    float* Rq = set_f(par, lay.Rq);
    float* Kq = set_f(par, lay.Kq);
    float* E = set_f(par, lay.E);
    float* F = set_f(par, lay.F);
    float* G = set_f(par, lay.G);
    float* ET = set_f(par, lay.ET);
    for (int base = 0; base < HD * MAX_SB; base += NTHREADS) {
      const int e = base + tid, p = e % MAX_SB, i = e / MAX_SB;
      const bool act = p < nsb && e < HD * MAX_SB;
      float cl[SB], cx[SB], acc = 0.f;
#pragma unroll
      for (int q = 0; q < SB; ++q) {
        cx[q] = acc;
        if (act) acc += to_f32(Sl[L::row(p * SB + q) + i]) * LOG2E;
        cl[q] = acc;
      }
      float tq[MAX_SB];
#pragma unroll
      for (int q = 0; q < MAX_SB; ++q) tq[q] = __shfl_sync(FULL, acc, (lane & ~(MAX_SB - 1)) | q);
      if (act) {
        float before = 0.f, after = 0.f, g = 0.f;
#pragma unroll
        for (int q = 0; q < MAX_SB; ++q) {
          if (q < p) before += tq[q];
          if (q > p) after += tq[q];  // sub-blocks past nsb hold 0
        }
        E[p * HD + i] = ex2(before);
        F[p * HD + i] = ex2(after);
#pragma unroll
        for (int q = MAX_SB - 2; q >= 0; --q)  // 2^{b_{p-1} - b_q}, q = p-1, p-2, ..
          if (q < p) {
            G[(p * MAX_SB + q) * HD + i] = ex2(g);
            g += tq[q];
          }
        if (p == nsb - 1) ET[i] = ex2(before + acc);
        const bool mine = p % CL == rank;
        const int slot = (p / CL) * SB;
#pragma unroll
        for (int q = 0; q < SB; ++q) {
          const int t = p * SB + q, d = L::row(t) + i;
          const float rv = to_f32(Sr[d]), kv = to_f32(Sk[d]);
          Rq[t * LD + i] = rv * ex2(cx[q]);
          Kq[t * LD + i] = kv * ex2(acc - cl[q]);
          if (mine) {
            const int w = (slot + q) * LD + i;
            R[w] = rv;
            K[w] = kv;
            Cl[w] = cl[q];
            Cp[w] = cx[q];
          }
        }
      }
    }
    float* V = set_f(par, lay.V);
    for (int e = tid; e < cp * JT; e += NTHREADS) V[e] = to_f32(Sv[e]);
  };

  for (int i = tid; i < HD; i += NTHREADS) Us[i] = to_f32(u[b * usb + h * ush + i]);
  for (int e = tid; e < HD * JT; e += NTHREADS)
    Sb[e] = S0 ? S0[srow + (long long)(e / JT) * HD + e % JT] : 0.f;
  for (int e = tid; e < (cp - c) * HD; e += NTHREADS) {
    const int d = L::row(c + e / HD) + e % HD;
    Sr[d] = Sk[d] = Sl[d] = from_f32<T>(0.f);
  }
  for (int e = tid; e < (cp - c) * JT; e += NTHREADS) Sv[c * JT + e] = from_f32<T>(0.f);
  if (tid == 0) nitems_s = build_items(items, nsb, rank, CL);
  int nwork = 0;  // NQ lanes for each of this CTA's items of A, set once they are listed
  // this CTA's items of A for chunk m (prep set and A buffer m % 2), each
  // split over NQ lanes by channel, stored into every CTA of the cluster
  auto compute_a = [&](int m) {
    const int par = m & 1;
    {
      const float* Rq = set_f(par, lay.Rq);
      const float* Kq = set_f(par, lay.Kq);
      const float* G = set_f(par, lay.G);
      const int abuf = par * MAX_CHUNK * LDA;
      for (int base = 0; base < nwork; base += NTHREADS) {
        const int it = base + tid, qch = it % NQ;
        const bool act = it < nwork;
        const int code = act ? items[it / NQ] : 0;
        const int row = code & 63, s0 = 4 * ((code >> 6) & 15), kind = (code >> 10) & 3;
        const int top = code >> 12;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
        if (act && kind == 0) {
          const float* Gp = G + top * HD;
#pragma unroll 4
          for (int i = qch; i < HD; i += NQ) {
            float rv[4], kv[4];
            const float g = Gp[i];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              rv[a] = Rq[(row + a) * LD + i];
              kv[a] = Kq[(s0 + a) * LD + i] * g;
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(rv[a], kv[bb], acc[a][bb]);
          }
        } else if (act) {
          // strip: row t against s0..s0+3 of the same sub-block, pair decays
          // below the diagonal, the bonus r.u.k on it, zero above; branch-free
          // (an entry on or above the diagonal gets the exponent -inf, so
          // 2^-inf = 0), so an iteration's loads are in flight together
          const int tl = top * SB + row % SB, sl = top * SB + s0 % SB, dt = row - s0;
          float cap[4];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) cap[bb] = bb < dt ? 0.f : __int_as_float(0xff800000);  // -inf
#pragma unroll 4
          for (int i = qch; i < HD; i += NQ) {
            const float rv = R[tl * LD + i], cx = Cp[tl * LD + i];
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              const float kv = K[(sl + bb) * LD + i], cl = Cl[(sl + bb) * LD + i];
              acc[0][bb] = fmaf(rv * kv, ex2(fminf(cx - cl, cap[bb])), acc[0][bb]);
            }
          }
          if (dt < 4) {
            float bonus = 0.f;
#pragma unroll 4
            for (int i = qch; i < HD; i += NQ)
              bonus = fmaf(R[tl * LD + i] * Us[i], K[tl * LD + i], bonus);
#pragma unroll
            for (int bb = 0; bb < 4; ++bb)
              if (bb == dt) acc[0][bb] = bonus;
          }
        }
        const bool tiles = __any_sync(FULL, act && kind == 0);
#pragma unroll
        for (int off = 1; off < NQ; off <<= 1)
#pragma unroll
          for (int a = 0; a < 4; ++a)
            if (a == 0 || tiles)
#pragma unroll
              for (int bb = 0; bb < 4; ++bb)
                acc[a][bb] += __shfl_xor_sync(FULL, acc[a][bb], off);
        if (act && (kind == 0 || qch == 0)) {
          float4 out = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
#pragma unroll
          for (int a = 1; a < 4; ++a)
            if (a == qch && kind == 0) out = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
          const int at = abuf + (row + (kind == 0 ? qch : 0)) * LDA + s0;
#pragma unroll
          for (int q = 0; q < CL; ++q) *reinterpret_cast<float4*>(Adst[q] + at) = out;
        }
      }
    }
  };

  // y and the state update of chunk n: warps 0-3 y, two rows x four
  // columns a thread, the state term then A . v (bonus included); warps
  // 4-7 the state update, two channels x four columns a thread.  Both read
  // Sc; Sn is the other buffer.
  auto output_and_state = [&](int n) {
    const int par = n & 1;
    {
      const float* Rq = set_f(par, lay.Rq);
      const float* Kq = set_f(par, lay.Kq);
      const float* V = set_f(par, lay.V);
      const float* E = set_f(par, lay.E);
      const float* F = set_f(par, lay.F);
      const float* ET = set_f(par, lay.ET);
      const float* Sc = Sb + par * HD * JT;  // S before the chunk
      float* Sn = Sb + (par ^ 1) * HD * JT;  // S after it
      const float* Ab = A + par * MAX_CHUNK * LDA;
      const long long t0 = (long long)n * c;
      constexpr int HALF = NTHREADS / 2;
      if (tid < HALF) {
        for (int e = tid; e < (c + 1) / 2 * J4; e += HALF) {
          const int t = 2 * (e / J4), q = e % J4;
          const float* r0 = Rq + t * LD;
          const float* Ep = E + (t / SB) * HD;
          float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
#pragma unroll 8
          for (int i = 0; i < HD; ++i) {
            const float4 s4 = reinterpret_cast<const float4*>(Sc + i * JT)[q];
            const float ep = Ep[i];
            fma4(acc0, r0[i] * ep, s4);
            fma4(acc1, r0[LD + i] * ep, s4);
          }
          const float* a0 = Ab + t * LDA;
#pragma unroll 4
          for (int s = 0; s <= t + 1; ++s) {
            const float4 v4 = reinterpret_cast<const float4*>(V + s * JT)[q];
            fma4(acc0, a0[s], v4);  // A[t][t + 1] is 0
            fma4(acc1, a0[LDA + s], v4);
          }
          store4<T>(yb + (t0 + t) * ys + 4 * q, acc0);
          if (t + 1 < c) store4<T>(yb + (t0 + t + 1) * ys + 4 * q, acc1);
        }
      } else {
        // S <- diag(2^{cum_T}) S + sum_p diag(F_p) sum_{s in p} Kq_s (x) v_s
        for (int e = tid - HALF; e < HD / 2 * J4; e += HALF) {
          const int i = 2 * (e / J4), q = e % J4;
          float4 s0 = reinterpret_cast<const float4*>(Sc + i * JT)[q];
          float4 s1 = reinterpret_cast<const float4*>(Sc + (i + 1) * JT)[q];
          const float et0 = ET[i], et1 = ET[i + 1];
          s0 = make_float4(s0.x * et0, s0.y * et0, s0.z * et0, s0.w * et0);
          s1 = make_float4(s1.x * et1, s1.y * et1, s1.z * et1, s1.w * et1);
          for (int p = 0; p < nsb; ++p) {
            float4 part0 = make_float4(0.f, 0.f, 0.f, 0.f), part1 = part0;
#pragma unroll 8
            for (int w = 0; w < SB; ++w) {
              const int s = p * SB + w;
              const float4 v4 = reinterpret_cast<const float4*>(V + s * JT)[q];
              fma4(part0, Kq[s * LD + i], v4);
              fma4(part1, Kq[s * LD + i + 1], v4);
            }
            fma4(s0, F[p * HD + i], part0);
            fma4(s1, F[p * HD + i + 1], part1);
          }
          reinterpret_cast<float4*>(Sn + i * JT)[q] = s0;
          reinterpret_cast<float4*>(Sn + (i + 1) * JT)[q] = s1;
        }
      }
    }
  };

  load_chunk<T, HD, CL>(Sr, Sk, Sl, Sv, rb, kb, lb, vb, rs, ks, ls, vs, 0, c, vec, tid);
  cp_async_wait_all();
  __syncthreads();
  prep(0);
  // the prep is visible, and every CTA of the cluster has started before
  // any stores into another's A
  if constexpr (CL > 1) cg::this_cluster().sync(); else __syncthreads();
  nwork = nitems_s * NQ;
  const int nch = Tlen / c;
  auto stage = [&](int m) {
    load_chunk<T, HD, CL>(Sr, Sk, Sl, Sv, rb, kb, lb, vb, rs, ks, ls, vs, (long long)m * c, c,
                          vec, tid);
  };
  if (nch > 1) stage(1);
  compute_a(0);
  cp_async_wait_all();
  if constexpr (CL > 1) cg::this_cluster().sync(); else __syncthreads();
  if (nch > 1) prep(1);
  __syncthreads();

  // A runs one chunk ahead of y: A of chunk n + 1 needs only its own prep,
  // so it shares a phase with y and the state update of chunk n, and the
  // loads of chunk n + 2 are in flight under both
  for (int n = 0; n < nch; ++n) {
    if (n + 2 < nch) stage(n + 2);  // the staging is free: chunk n + 1 is prepped
    if (states) {  // chunk n's entry state, this CTA's columns (training)
      const float* Sc = Sb + (n & 1) * HD * JT;
      float* dst = states + (((long long)b * H + h) * nch + n) * HD * HD + j0;
      for (int e = tid; e < HD * JT; e += NTHREADS) dst[(long long)(e / JT) * HD + e % JT] = Sc[e];
    }
    output_and_state(n);
    if (n + 1 < nch) compute_a(n + 1);
    cp_async_wait_all();  // chunk n + 2 is staged (this thread's copies)
    // (1) A of chunk n + 1 is whole in every CTA, S after chunk n is whole,
    // the staging is visible
    if constexpr (CL > 1) cg::this_cluster().sync(); else __syncthreads();
    if (n + 2 < nch) prep(n & 1);  // chunk n + 2 into the set chunk n used
    __syncthreads();  // (2) the prep is whole
  }
  const float* Sf = Sb + (nch & 1) * HD * JT;
  for (int e = tid; e < HD * JT; e += NTHREADS)
    S_fin[srow + (long long)(e / JT) * HD + e % JT] = Sf[e];
}

// Decode route (c == 1): one CTA per (head, batch).  Thread tid holds the
// 16-byte column quad tid % QR of rows tid / QR, tid / QR + RPP, .. of S in
// registers for the whole sweep; each token is staged in shared memory, the
// state term is summed over the thread's rows and then over the RPP row
// groups.  Two barriers a token.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS_D)
wkv_decode_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ lw, const T* __restrict__ u,
                  const float* __restrict__ S0, T* __restrict__ y, float* __restrict__ S_fin,
                  float* __restrict__ states, int Tlen, int H, Strides rs, Strides ks,
                  Strides vs, Strides ls, long long usb, long long ush, int s0_vec) {
  constexpr int QR = HD / 4, RPP = NTHREADS_D / QR, MR = (HD + RPP - 1) / RPP;
  constexpr int GR = RPP < HD ? RPP : HD;            // row groups that hold rows
  constexpr int NW = (HD + 31) / 32;                 // warps that stage a token
  __shared__ __align__(16) float tok[2][4][HD];      // r, k, e^{lw}, v
  __shared__ __align__(16) float red[2][RPP][HD];    // state term by row group
  __shared__ float bonus[2][NW];                     // r.u.k by warp
  const int tid = threadIdx.x, q = tid % QR, r0 = tid / QR;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long srow = ((long long)b * H + h) * HD * HD;
  float4 S[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int i = r0 + m * RPP;
    S[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (S0 && i < HD) {
      const float* src = S0 + srow + (long long)i * HD + 4 * q;
      S[m] = s0_vec ? *reinterpret_cast<const float4*>(src)
                    : make_float4(src[0], src[1], src[2], src[3]);
    }
  }
  const float uu = tid < HD ? to_f32(u[b * usb + h * ush + tid]) : 0.f;
  const long long ys = (long long)H * HD;
  T* yb = y + (long long)b * Tlen * ys + h * HD;
  for (int t = 0; t < Tlen; ++t) {
    const int buf = t & 1;
    if (states) {  // token t's entry state (training)
      float* dst = states + (((long long)b * H + h) * Tlen + t) * HD * HD + 4 * q;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int i = r0 + m * RPP;
        if (i < HD) *reinterpret_cast<float4*>(dst + (long long)i * HD) = S[m];
      }
    }
    if (tid < NW * 32) {
      float ruk = 0.f;
      if (tid < HD) {
        const float rv = to_f32(r[b * rs.b + t * rs.t + h * rs.h + tid]);
        const float kv = to_f32(k[b * ks.b + t * ks.t + h * ks.h + tid]);
        tok[buf][0][tid] = rv;
        tok[buf][1][tid] = kv;
        tok[buf][2][tid] = expf(to_f32(lw[b * ls.b + t * ls.t + h * ls.h + tid]));
        tok[buf][3][tid] = to_f32(v[b * vs.b + t * vs.t + h * vs.h + tid]);
        ruk = rv * uu * kv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      if (tid % 32 == 0) bonus[buf][tid / 32] = ruk;
    }
    __syncthreads();
    const float4 v4 = reinterpret_cast<const float4*>(tok[buf][3])[q];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int i = r0 + m * RPP;
      if (i < HD) {
        const float rv = tok[buf][0][i], kv = tok[buf][1][i], w = tok[buf][2][i];
        fma4(acc, rv, S[m]);
        S[m].x = fmaf(kv, v4.x, w * S[m].x);
        S[m].y = fmaf(kv, v4.y, w * S[m].y);
        S[m].z = fmaf(kv, v4.z, w * S[m].z);
        S[m].w = fmaf(kv, v4.w, w * S[m].w);
      }
    }
    if (r0 < GR) reinterpret_cast<float4*>(red[buf][r0])[q] = acc;
    __syncthreads();
    if (tid < HD) {
      float yv = 0.f, bon = 0.f;
#pragma unroll
      for (int g = 0; g < GR; ++g) yv += red[buf][g][tid];
#pragma unroll
      for (int w = 0; w < NW; ++w) bon += bonus[buf][w];
      yb[(long long)t * ys + tid] = from_f32<T>(fmaf(bon, tok[buf][3][tid], yv));
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int i = r0 + m * RPP;
    if (i < HD) *reinterpret_cast<float4*>(S_fin + srow + (long long)i * HD + 4 * q) = S[m];
  }
}

// ---------------------------------------------------------------------------
// Backward (training): wkv_chunked_bwd.  The JAX package has no WKV backward
// kernel (XLA differentiates its jnp scan); this one computes the same
// gradient from the forward's chunk-entry states.  Per chunk of a (batch,
// head) row, with entry state S, the gradient dS of the state leaving it,
// cp_t the running sum of lw before row t, cum_t after it, tot the chunk's
// sum and B_ts = dy_t.v_s:
//   dS_in = diag(e^tot) dS + G,  G = sum_t (r_t e^cp_t)^T dy_t
//   dr_t  = (dy_t S^T) e^cp_t + sum_{s<t} B_ts k_s e^(cp_t - cum_s) + B_tt u k_t
//   dk_s  = sum_{t>s} B_ts r_t e^(cp_t - cum_s) + (v_s dS^T) e^(tot - cum_s) + B_ss u r_s
//   dv_s  = sum_{t>=s} A_ts dy_t (A_ss the bonus r_s.u.k_s) + (k_s e^(tot - cum_s)) dS
//   du    = sum_t B_tt r_t k_t
// and the log decay's closed form, within the chunk
//   dlw_t = rowsum(S_out .* dS) + sum_{t'>t} (r dr' - k dk')_t' - (k dk')_t
// (dr', dk' without the bonus; S_out the next chunk's entry state, S_fin
// for the last): a chunk's total of r dr' - k dk' is rowsum(S .* dS_in) -
// rowsum(S_out .* dS), its pairwise parts cancelling, so the sum over every
// later chunk telescopes to the first term.  Only dS crosses chunks, and
// elementwise once each chunk's G is known.  So a call is three kernels,
// named wkv_bwd_*, counted as one launch:
//   1. wkv_bwd_state_kernel, a CTA per (chunk, head, batch), every chunk at
//      once: G into the scratch dS buffer, e^tot and the chunk's du.
//   2. wkv_bwd_scan_kernel, a thread per four elements of a (batch, head)'s
//      dS: march the chunks in reverse from dS_fin, eight chunks' loads in
//      flight, overwriting each G with the dS leaving its chunk, then dS0;
//      du summed over the chunks in order.
//   3. wkv_bwd_chunk_kernel, a CTA per (chunk, head, batch): the rest.
// What bounds it: operations (about 3.6 MFLOP a 64-row chunk of hd 64, f32
// on the CUDA cores) and the shared-memory traffic of the products; each
// CTA issues all its loads of a chunk's rows and states before its first
// store (one round trip to memory).  The design of pass 3:
//   * the forward's factored sub-blocks.  A chunk is cut into sub-blocks of
//     16 rows (a ragged chunk padded with zero rows, which leaves every sum
//     unchanged), with running sums of lw in log2 units inside each (Cl
//     inclusive, Cp exclusive, tot_q the sub-block's), Rq = r 2^Cp and
//     Kq = k 2^(tot_q - Cl), ET_q = 2^tot_q, every exponent <= 0.  Off the
//     diagonal sub-blocks each pairwise sum is a dense product of 4 x 4
//     register tiles: A_pq = Rq_p diag(2^(b_{p-1} - b_q)) Kq_q^T; dr' takes
//     its state term and its pairs by Horner over the source sub-blocks,
//       acc = dy S^T;  acc = acc ET_q + B_pq Kq_q (q = 0 .. p-1);  dr' = 2^Cp acc,
//     and dk' over the target sub-blocks, from the other end,
//       acc = v dS^T;  acc = acc ET_p + B_pq^T Rq_p (p = last .. q+1);  dk' = 2^(tot_q - Cl) acc,
//     so every factor is a product of terms <= 1, each at least the exact
//     one, and a factor underflows only where the term itself is below
//     f32's range.  Only the diagonal sub-blocks take an exponential per
//     pair: A's, in 1 x 4 strips of their lower triangle (40960 a 64-row
//     chunk of hd 64, a quarter of them masked), and one that dr' and dk'
//     share, a thread per (channel, sub-block) walking its 120 pairs
//     (30720), against the pairwise form's 3 x 129024.
//   * 16-byte shared loads without bank conflicts in B and the products of
//     dr', dk' and dv: each reads rows of one operand and columns of the
//     other (or columns of both), so v, S and dS are also stored
//     transposed, and a warp's lanes take neighbouring column tiles (one
//     row broadcast, 256 contiguous bytes).  A's tiles (rows of both) and
//     strips do conflict; they are a thread an item after B, three warps
//     of tiles and five of strips.
//   * shared memory: twelve 64 x 68 f32 arrays (r, k, Cl, Rq, Kq, dy, v^T,
//     S^T, dS, dS^T, A, B; dr' and dk' reuse r and k, which the kernel
//     reloads from global memory for its last phase), 217.6 KB at
//     c = hd = 64, so one CTA an SM: keeping fewer would recompute
//     exponentials in the inner loops or split a chunk over a cluster.
//     2048 CTAs at rwkv6-1.6b's training shape, 15.5 waves on 132 SMs.
//   * every sum in a fixed order and no atomics: bitwise repeatable.
// ---------------------------------------------------------------------------

constexpr int NTHREADS_B = 256;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 a) { *reinterpret_cast<float4*>(p) = a; }
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 ex2_4(float4 a) {
  return make_float4(ex2(a.x), ex2(a.y), ex2(a.z), ex2(a.w));
}

// 4 x 4 register tiles, acc[a] the four columns of row a; every x loop in
// order.  P rows, Q columns: acc[a][b] += sum_{x < n} P[a*ldp + x] Q[x*ldq + b]
// (n a multiple of 4), P's entries scaled by sc[x] where sc is given.
__device__ __forceinline__ void mm_rc(float4 (&acc)[4], const float* P, int ldp, const float* Q,
                                      int ldq, int n, const float* sc = nullptr) {
  for (int x = 0; x < n; x += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = ld4(P + a * ldp + x);
    if (sc) {
      const float4 s = ld4(sc + x);
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = mul4(p[a], s);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) q[m] = ld4(Q + (x + m) * ldq);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      fma4(acc[a], p[a].x, q[0]);
      fma4(acc[a], p[a].y, q[1]);
      fma4(acc[a], p[a].z, q[2]);
      fma4(acc[a], p[a].w, q[3]);
    }
  }
}

// Columns of both: acc[a][b] += sum_{x < n} P[x*ldp + a] Q[x*ldq + b].
__device__ __forceinline__ void mm_cc(float4 (&acc)[4], const float* P, int ldp, const float* Q,
                                      int ldq, int n) {
#pragma unroll 4
  for (int x = 0; x < n; ++x) {
    const float4 p = ld4(P + x * ldp), q = ld4(Q + x * ldq);
    fma4(acc[0], p.x, q);
    fma4(acc[1], p.y, q);
    fma4(acc[2], p.z, q);
    fma4(acc[3], p.w, q);
  }
}

// Rows of both, scaled: acc[a][b] += sum_{x < n} P[a*ldp + x] g[x] Q[b*ldq + x].
__device__ __forceinline__ void mm_rr(float4 (&acc)[4], const float* P, int ldp, const float* g,
                                      const float* Q, int ldq, int n) {
  for (int x = 0; x < n; x += 4) {
    const float4 gg = ld4(g + x);
    float4 p[4], q[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = ld4(P + a * ldp + x);
#pragma unroll
    for (int b = 0; b < 4; ++b) q[b] = mul4(ld4(Q + b * ldq + x), gg);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float o[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        o[b] = fmaf(p[a].w, q[b].w, fmaf(p[a].z, q[b].z, fmaf(p[a].y, q[b].y, p[a].x * q[b].x)));
      acc[a].x += o[0];
      acc[a].y += o[1];
      acc[a].z += o[2];
      acc[a].w += o[3];
    }
  }
}

// Four elements of a row as f32: one 16-byte (f32) or 8-byte (bf16) load.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// The chunk's rows of r, k, dy and lw * log2(e) (t < c; zeros to cp) as f32
// rows of pitch ld, v as columns (VT, pitch ldt) where VT is given, and
// dy_t.v_t (BD, summed over the row's lanes in a fixed order) where BD is;
// (b, n*c, h, 0) is element `base`, and every pointer 16-byte aligned.
// Each thread issues all its loads (four vectors of each array at most)
// before its first store, so a chunk's rows cost one round trip to memory.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* R, float* K, float* Y, float* CL, float* VT,
                                          float* BD, const T* r, const T* k, const T* dy,
                                          const T* lw, const T* v, long long base,
                                          long long rows, int c, int cp, int ld, int ldt,
                                          int tid) {
  constexpr int V4 = HD / 4, PER = (MAX_CHUNK * V4 + NTHREADS_B - 1) / NTHREADS_B;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x[PER][5];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * NTHREADS_B, t = e / V4, i = 4 * (e % V4);
    const long long g = base + t * rows + i;
    const bool in = e < cp * V4 && t < c;
    x[m][0] = in ? load4(r + g) : zero;
    x[m][1] = in ? load4(k + g) : zero;
    x[m][2] = in ? load4(dy + g) : zero;
    x[m][3] = in ? load4(lw + g) : zero;
    x[m][4] = in ? load4(v + g) : zero;
  }
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * NTHREADS_B, t = e / V4, i = 4 * (e % V4), w = t * ld + i;
    if (e < cp * V4) {
      st4(R + w, x[m][0]);
      st4(K + w, x[m][1]);
      st4(Y + w, x[m][2]);
      st4(CL + w, make_float4(x[m][3].x * LOG2E, x[m][3].y * LOG2E, x[m][3].z * LOG2E,
                              x[m][3].w * LOG2E));
      if (VT) {
        VT[i * ldt + t] = x[m][4].x;
        VT[(i + 1) * ldt + t] = x[m][4].y;
        VT[(i + 2) * ldt + t] = x[m][4].z;
        VT[(i + 3) * ldt + t] = x[m][4].w;
      }
    }
    if (BD) {
      const float4 a = x[m][2], b = x[m][4];
      float dot = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
#pragma unroll
      for (int off = V4 / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (e < cp * V4 && i == 0) BD[t] = dot;
    }
  }
}

// Pass 1: G = (r e^cp)^T dy into dS's slot of the chunk, 2^tot and the
// chunk's du = sum_t (dy_t.v_t) r_t k_t.  Shared memory: r, k, dy, Cl
// (cp x LD each), the sub-blocks' totals and parts of du, and dy_t.v_t.
template <int HD>
__host__ __device__ constexpr size_t state_smem_floats(int cp) {
  return 4 * (size_t)cp * (HD + 4) + 2 * MAX_SB * HD + MAX_CHUNK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS_B)
wkv_bwd_state_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ lw, const T* __restrict__ dy, float* __restrict__ G,
                     float* __restrict__ et, float* __restrict__ du_part, int Tlen, int H, int c) {
  constexpr int LD = HD + 4, J4 = HD / 4;
  const int cp = (c + SB - 1) / SB * SB, nsb = cp / SB;
  extern __shared__ __align__(16) float bsm[];
  float* R = bsm;
  float* K = R + cp * LD;
  float* Y = K + cp * LD;
  float* CL = Y + cp * LD;
  float* TOT = CL + cp * LD;
  float* DUP = TOT + MAX_SB * HD;
  float* BD = DUP + MAX_SB * HD;
  const int tid = threadIdx.x, n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nch = Tlen / c;
  const long long rows = (long long)H * HD;
  const long long base = ((long long)b * Tlen + (long long)n * c) * rows + (long long)h * HD;
  const long long slot = ((long long)b * H + h) * nch + n;  // the chunk's index in the scratch

  load_rows<T, HD>(R, K, Y, CL, nullptr, BD, r, k, dy, lw, v, base, rows, c, cp, LD, 0, tid);
  __syncthreads();
  // a thread per (channel, sub-block): the running sums in place, the
  // sub-block's total and its part of du; then r e^cp in place, cp_t the
  // sub-blocks before plus Cp_t, and du's parts summed in order
  const bool col = tid < HD * nsb;
  const int i = tid % HD, p = tid / HD;
  if (col) {
    float acc = 0.f, dua = 0.f;
    for (int q = 0; q < SB; ++q) {
      const int t = p * SB + q, w = t * LD + i;
      acc += CL[w];
      CL[w] = acc;
      dua = fmaf(BD[t] * R[w], K[w], dua);
    }
    TOT[p * HD + i] = acc;
    DUP[p * HD + i] = dua;
  }
  __syncthreads();
  if (col) {
    float before = 0.f, all = 0.f;
    for (int q = 0; q < nsb; ++q) {
      if (q < p) before += TOT[q * HD + i];
      all += TOT[q * HD + i];
    }
    float cx = 0.f;
    for (int q = 0; q < SB; ++q) {
      const int w = (p * SB + q) * LD + i;
      const float cl = CL[w];
      R[w] *= ex2(before + cx);
      cx = cl;
    }
    if (p == 0) {
      float du = 0.f;
      for (int q = 0; q < nsb; ++q) du += DUP[q * HD + i];
      et[slot * HD + i] = ex2(all);
      du_part[slot * HD + i] = du;
    }
  }
  __syncthreads();
  float* Gc = G + slot * HD * HD;
  for (int e = tid; e < J4 * J4; e += NTHREADS_B) {
    const int i0 = 4 * (e / J4), j0 = 4 * (e % J4);
    float4 acc[4] = {};
    mm_cc(acc, R + i0, LD, Y + j0, LD, cp);
#pragma unroll
    for (int a = 0; a < 4; ++a) st4(Gc + (i0 + a) * HD + j0, acc[a]);
  }
}

// Pass 2: dS holds each chunk's G (B, H, T/c, hd, hd); march the chunks in
// reverse, dS <- 2^tot dS + G, leaving in each slot the dS of the state
// leaving that chunk; dS0 the last.  A thread per four elements, the loads
// of NB chunks in flight together.  du: the chunks' parts summed in order.
constexpr int SCAN_THREADS = 64;

__global__ void __launch_bounds__(SCAN_THREADS)
wkv_bwd_scan_kernel(float* __restrict__ dS, const float* __restrict__ et,
                    const float* __restrict__ du_part, const float* __restrict__ dS_fin,
                    float* __restrict__ dS0, float* __restrict__ du, int nch, int hd) {
  constexpr int NB = 8;
  const int e = 4 * (blockIdx.x * SCAN_THREADS + threadIdx.x);
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long mat = (long long)hd * hd;
  if (e < mat) {
    float4 cur = dS_fin ? ld4(dS_fin + bh * mat + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    float* p = dS + bh * nch * mat + e;
    const float* ep = et + bh * nch * hd + e / hd;
    for (int top = nch - 1; top >= 0; top -= NB) {
      float4 g[NB];
      float w[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (top - q >= 0) {
          g[q] = ld4(p + (top - q) * mat);
          w[q] = ep[(long long)(top - q) * hd];
        }
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (top - q >= 0) {
          st4(p + (top - q) * mat, cur);
          cur = make_float4(fmaf(w[q], cur.x, g[q].x), fmaf(w[q], cur.y, g[q].y),
                            fmaf(w[q], cur.z, g[q].z), fmaf(w[q], cur.w, g[q].w));
        }
    }
    if (dS0) st4(dS0 + bh * mat + e, cur);
  }
  if (blockIdx.x == 0 && threadIdx.x < hd) {
    float acc = 0.f;
    for (int n = 0; n < nch; ++n) acc += du_part[(bh * nch + n) * hd + threadIdx.x];
    du[bh * hd + threadIdx.x] = acc;
  }
}

// Shared memory of pass 3 in floats, for a chunk padded to cp rows.
template <int HD>
struct BwdLayout {
  static constexpr int LD = HD + 4;  // pitch of the (x HD) arrays: 16-byte rows
  int LC;                            // pitch of the (x cp) arrays
  size_t R, K, CL, RQ, KQ, Y, VT, ST, DS, DST, A, B, TOT, ET, F, GQ, U, BASE, ZT, total;
  __host__ __device__ explicit BwdLayout(int cp) : LC(cp + 4) {
    size_t o = 0;
    auto take = [&o](size_t n) {
      const size_t at = o;
      o += (n + 3) & ~size_t(3);
      return at;
    };
    R = take(cp * LD);
    K = take(cp * LD);
    CL = take(cp * LD);
    RQ = take(cp * LD);
    KQ = take(cp * LD);
    Y = take(cp * LD);
    VT = take(HD * LC);
    ST = take(HD * LD);
    DS = take(HD * LD);
    DST = take(HD * LD);
    A = take(cp * LC);
    B = take(cp * LC);
    TOT = take(MAX_SB * HD);
    ET = take(MAX_SB * HD);
    F = take(MAX_SB * HD);
    GQ = take(MAX_SB * MAX_SB * HD);
    U = take(HD);
    BASE = take(HD);
    ZT = take(MAX_SB * HD);
    total = o;
  }
};

// The row t (in sub-block) and first source s4 (in quads) of strip w of a
// diagonal sub-block's 40: rows 0-3 one quad each, 4-7 two, 8-11 three,
// 12-15 four.
__device__ __forceinline__ void strip_of(int w, int& tl, int& s4) {
  if (w < 4) {
    tl = w;
    s4 = 0;
  } else if (w < 12) {
    tl = 4 + (w - 4) / 2;
    s4 = (w - 4) % 2;
  } else if (w < 24) {
    tl = 8 + (w - 12) / 3;
    s4 = (w - 12) % 3;
  } else {
    tl = 12 + (w - 24) / 4;
    s4 = (w - 24) % 4;
  }
}

// Pass 3.  r, k, v, lw, dy and the outputs dr, dk, dv, dlw are (B, T, H,
// HD) contiguous; states (B, H, T/c, HD, HD), dS (the scan's, same shape)
// and S_fin (B, H, HD, HD) f32; S_fin null where the last chunk's dS is 0.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS_B)
wkv_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ lw, const T* __restrict__ u, const T* __restrict__ dy,
                     const float* __restrict__ states, const float* __restrict__ S_fin,
                     const float* __restrict__ dS, T* __restrict__ dr, T* __restrict__ dk,
                     T* __restrict__ dv, T* __restrict__ dlw, int Tlen, int H, int c,
                     long long usb, long long ush) {
  constexpr int LD = HD + 4, J4 = HD / 4;
  constexpr unsigned FULL = 0xffffffffu;
  const int cp = (c + SB - 1) / SB * SB, nsb = cp / SB, R4 = cp / 4;
  const BwdLayout<HD> lay(cp);
  const int LC = lay.LC;
  extern __shared__ __align__(16) float bsm[];
  float* R = bsm + lay.R;    // r; then dr' before the diagonal sub-blocks' pairs
  float* K = bsm + lay.K;    // k; then dk' likewise
  float* CL = bsm + lay.CL;  // running sums of lw * log2(e) inside each sub-block
  float* RQ = bsm + lay.RQ;
  float* KQ = bsm + lay.KQ;
  float* Y = bsm + lay.Y;
  float* VT = bsm + lay.VT;
  float* ST = bsm + lay.ST;
  float* DS = bsm + lay.DS;
  float* DST = bsm + lay.DST;
  float* A = bsm + lay.A;    // A_ts at [t][s], the bonus on the diagonal, 0 above it
  float* Bm = bsm + lay.B;   // dy_t.v_s at [t][s], s <= t
  float* TOT = bsm + lay.TOT;
  float* ET = bsm + lay.ET;
  float* F = bsm + lay.F;    // 2^(tot - b_q): the sub-blocks after q
  float* GQ = bsm + lay.GQ;  // 2^(b_{p-1} - b_q) at (p * MAX_SB + q)
  float* U = bsm + lay.U;
  float* BASE = bsm + lay.BASE;
  float* ZT = bsm + lay.ZT;
  const int tid = threadIdx.x, n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nch = Tlen / c;
  const long long rows = (long long)H * HD;
  const long long base = ((long long)b * Tlen + (long long)n * c) * rows + (long long)h * HD;
  const long long bh = (long long)b * H + h, slot = bh * nch + n;
  const float* Sn = states + slot * HD * HD;
  const float* dSn = dS + slot * HD * HD;
  const float* Sout = n + 1 < nch ? Sn + HD * HD : S_fin ? S_fin + bh * HD * HD : nullptr;

  // phase 0: the rows, S^T, dS and dS^T, u; rowsum(S_out .* dS) (a warp a
  // row, in a fixed order); the running sums
  load_rows<T, HD>(R, K, Y, CL, VT, nullptr, r, k, dy, lw, v, base, rows, c, cp, LD, LC, tid);
  {
    // S, dS and S_out, every load issued before the first store; S^T, dS,
    // dS^T, and rowsum(S_out .* dS) over the V4 lanes of a row in a fixed order
    constexpr int V4 = HD / 4, PS = (HD * V4 + NTHREADS_B - 1) / NTHREADS_B;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s4[PS], d4[PS], o4[PS];
#pragma unroll
    for (int m = 0; m < PS; ++m) {
      const int e = tid + m * NTHREADS_B;
      const bool in = e < HD * V4;
      s4[m] = in ? ld4(Sn + 4 * e) : zero;
      d4[m] = in ? ld4(dSn + 4 * e) : zero;
      o4[m] = in && Sout ? ld4(Sout + 4 * e) : zero;
    }
#pragma unroll
    for (int m = 0; m < PS; ++m) {
      const int e = tid + m * NTHREADS_B, i = e / V4, j = 4 * (e % V4);
      float dot = o4[m].x * d4[m].x + o4[m].y * d4[m].y + o4[m].z * d4[m].z + o4[m].w * d4[m].w;
#pragma unroll
      for (int off = V4 / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
      if (e < HD * V4) {
        ST[j * LD + i] = s4[m].x;
        ST[(j + 1) * LD + i] = s4[m].y;
        ST[(j + 2) * LD + i] = s4[m].z;
        ST[(j + 3) * LD + i] = s4[m].w;
        st4(DS + i * LD + j, d4[m]);
        DST[j * LD + i] = d4[m].x;
        DST[(j + 1) * LD + i] = d4[m].y;
        DST[(j + 2) * LD + i] = d4[m].z;
        DST[(j + 3) * LD + i] = d4[m].w;
        if (j == 0) BASE[i] = dot;
      }
    }
  }
  for (int i = tid; i < HD; i += NTHREADS_B) U[i] = to_f32(u[b * usb + h * ush + i]);
  __syncthreads();
  if (tid < HD * nsb) {  // the running sums inside each sub-block, in place, and its total
    const int i = tid % HD, p = tid / HD;
    float acc = 0.f;
    for (int q = 0; q < SB; ++q) {
      float* w = CL + (p * SB + q) * LD + i;
      acc += *w;
      *w = acc;
    }
    TOT[p * HD + i] = acc;
  }
  __syncthreads();
  // the factors, a thread per (channel, sub-block)
  if (tid < HD * nsb) {
    const int i = tid % HD, p = tid / HD;
    float after = 0.f;
    for (int q = p + 1; q < nsb; ++q) after += TOT[q * HD + i];
    const float tp = TOT[p * HD + i];
    ET[p * HD + i] = ex2(tp);
    F[p * HD + i] = ex2(after);
    float g = 0.f;
    for (int q = p - 1; q >= 0; --q) {
      GQ[(p * MAX_SB + q) * HD + i] = ex2(g);
      g += TOT[q * HD + i];
    }
    float cx = 0.f;
    for (int q = 0; q < SB; ++q) {
      const int w = (p * SB + q) * LD + i;
      const float cl = CL[w];
      RQ[w] = R[w] * ex2(cx);
      KQ[w] = K[w] * ex2(tp - cl);
      cx = cl;
    }
  }
  __syncthreads();

  // phase 1: B, a thread a 4 x 4 tile at or below the diagonal (a warp two
  // rows of tiles, conflict-free); then A, a thread an item: the tiles of
  // the off-diagonal sub-blocks (the factored product, sub-block pair k =
  // p(p-1)/2 + q), then the strips of the diagonal ones
  for (int e = tid; e < R4 * R4; e += NTHREADS_B) {
    const int t0 = 4 * (e / R4), s0 = 4 * (e % R4);
    if (s0 <= t0) {
      float4 acc[4] = {};
      mm_rc(acc, Y + t0 * LD, LD, VT + s0, LC, HD);
#pragma unroll
      for (int a = 0; a < 4; ++a) st4(Bm + (t0 + a) * LC + s0, acc[a]);
    }
  }
  const int noff = nsb * (nsb - 1) / 2 * 16;
  for (int e = tid; e < noff + 40 * nsb; e += NTHREADS_B) {
    if (e < noff) {
      const int k = e / 16;
      int p = 1;
      while (p * (p + 1) / 2 <= k) ++p;
      const int q = k - p * (p - 1) / 2, t0 = p * SB + 4 * (e / 4 % 4), s0 = q * SB + 4 * (e % 4);
      float4 at[4] = {};
      mm_rr(at, RQ + t0 * LD, LD, GQ + (p * MAX_SB + q) * HD, KQ + s0 * LD, LD, HD);
#pragma unroll
      for (int a = 0; a < 4; ++a) st4(A + (t0 + a) * LC + s0, at[a]);
      continue;
    }
    // row t against s0..s0+3 of its sub-block: pair decays below the
    // diagonal, the bonus r.u.k on it, 0 above (exponent -inf)
    int tl, s4;
    strip_of((e - noff) % 40, tl, s4);
    const int p = (e - noff) / 40, t = p * SB + tl, s0 = p * SB + 4 * s4, dt = t - s0;
    float cap[4];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) cap[bb] = bb < dt ? 0.f : __int_as_float(0xff800000);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < HD; i += 4) {
      const float4 rv = ld4(R + t * LD + i);
      const float4 cx = tl ? ld4(CL + (t - 1) * LD + i) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float4 kv = ld4(K + (s0 + bb) * LD + i), cl = ld4(CL + (s0 + bb) * LD + i);
        float a = acc[bb];
        a = fmaf(rv.x * kv.x, ex2(fminf(cx.x - cl.x, cap[bb])), a);
        a = fmaf(rv.y * kv.y, ex2(fminf(cx.y - cl.y, cap[bb])), a);
        a = fmaf(rv.z * kv.z, ex2(fminf(cx.z - cl.z, cap[bb])), a);
        a = fmaf(rv.w * kv.w, ex2(fminf(cx.w - cl.w, cap[bb])), a);
        acc[bb] = a;
      }
    }
    if (dt < 4) {
      float bonus = 0.f;
      for (int i = 0; i < HD; ++i) bonus = fmaf(R[t * LD + i] * U[i], K[t * LD + i], bonus);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        if (bb == dt) acc[bb] = bonus;
    }
    st4(A + t * LC + s0, make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
  __syncthreads();

  // phase 2, 4 x 4 tiles (rows t0.., columns c0..): dv to the output; dr'
  // and dk' but for the diagonal sub-blocks' pairs into R and K (read only
  // by phase 1)
  for (int e = tid; e < R4 * J4; e += NTHREADS_B) {
    const int t0 = 4 * (e / J4), c0 = 4 * (e % J4), p = t0 / SB;
    {
      float4 acc[4] = {};
      mm_cc(acc, A + t0 * LC + t0, LC, Y + t0 * LD + c0, LD, cp - t0);  // A^T dy, t >= s
      mm_rc(acc, KQ + t0 * LD, LD, DS + c0, LD, HD, F + p * HD);         // (k 2^(tot - cum)) dS
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (t0 + a < c) store4<T>(dv + base + (t0 + a) * rows + c0, acc[a]);
    }
    float4 dra[4] = {}, dka[4] = {};
    mm_rc(dra, Y + t0 * LD, LD, ST + c0, LD, HD);  // dy S^T
    for (int q = 0; q < p; ++q) {
      const float4 et = ld4(ET + q * HD + c0);
#pragma unroll
      for (int a = 0; a < 4; ++a) dra[a] = mul4(dra[a], et);
      mm_rc(dra, Bm + t0 * LC + q * SB, LC, KQ + q * SB * LD + c0, LD, SB);
    }
    mm_cc(dka, VT + t0, LC, DST + c0, LD, HD);  // v dS^T
    for (int q = nsb - 1; q > p; --q) {
      const float4 et = ld4(ET + q * HD + c0);
#pragma unroll
      for (int a = 0; a < 4; ++a) dka[a] = mul4(dka[a], et);
      mm_cc(dka, Bm + q * SB * LC + t0, LC, RQ + q * SB * LD + c0, LD, SB);
    }
    const float4 tq = ld4(TOT + p * HD + c0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = t0 + a;
      const float4 cx = t % SB ? ld4(CL + (t - 1) * LD + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 cl = ld4(CL + t * LD + c0);
      st4(R + t * LD + c0, mul4(dra[a], ex2_4(cx)));
      st4(K + t * LD + c0,
          mul4(dka[a], ex2_4(make_float4(tq.x - cl.x, tq.y - cl.y, tq.z - cl.z, tq.w - cl.w))));
    }
  }
  __syncthreads();

  // phase 3, a thread per (channel i, sub-block p): the diagonal
  // sub-block's pairs, one exponential each for dr' and dk'; the bonus; dr
  // and dk out; r dr' - k dk' summed by sub-block for dlw
  const bool col = tid < HD * nsb;
  const int ci = tid % HD, cpb = tid / HD, t00 = cpb * SB;
  float ys[SB], zs[SB];
  if (col) {
    float rr[SB], kk[SB], cl[SB], drd[SB], dkd[SB];
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int t = t00 + q;
      const long long g = base + t * rows + ci;
      rr[q] = t < c ? to_f32(r[g]) : 0.f;
      kk[q] = t < c ? to_f32(k[g]) : 0.f;
      cl[q] = CL[t * LD + ci];
      drd[q] = R[t * LD + ci];
      dkd[q] = K[t * LD + ci];
    }
#pragma unroll
    for (int t = 1; t < SB; ++t)
#pragma unroll
      for (int s = 0; s < t; ++s) {
        const float bts = Bm[(t00 + t) * LC + t00 + s];
        const float d = ex2(cl[t - 1] - cl[s]);  // Cp_t - Cl_s <= 0
        drd[t] = fmaf(bts * kk[s], d, drd[t]);
        dkd[s] = fmaf(bts * rr[t], d, dkd[s]);
      }
    const float ui = U[ci];
    float zt = 0.f;
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int t = t00 + q;
      const float bu = Bm[t * LC + t] * ui;
      ys[q] = kk[q] * dkd[q];
      zs[q] = rr[q] * drd[q] - ys[q];
      zt += zs[q];
      if (t < c) {
        const long long g = base + t * rows + ci;
        dr[g] = from_f32<T>(fmaf(bu, kk[q], drd[q]));
        dk[g] = from_f32<T>(fmaf(bu, rr[q], dkd[q]));
      }
    }
    ZT[cpb * HD + ci] = zt;
  }
  __syncthreads();
  if (col) {
    float run = BASE[ci];
    for (int q = nsb - 1; q > cpb; --q) run += ZT[q * HD + ci];
#pragma unroll
    for (int q = SB - 1; q >= 0; --q) {
      const int t = t00 + q;
      if (t < c) dlw[base + t * rows + ci] = from_f32<T>(run - ys[q]);
      run += zs[q];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// CTAs of a head that share A: pairs (1 where a head is one CTA).  A CTA of
// a pair has the shared memory of two sets of working rows (the pipelined
// prep); a CTA alone at hd 64 would need four diagonal sub-blocks' rows as
// well, more than the card's 227 KB.
template <int HD>
constexpr int cluster_size() { return Tile<HD>::NC >= 2 ? 2 : 1; }

// Once per kernel instance and device: allow the dynamic shared memory of
// the largest chunk.
template <typename T, int HD, int CL>
cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(wkv_chunk_kernel<T, HD, CL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<T, HD, CL>(MAX_CHUNK).total);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T, int HD>
cudaError_t launch_chunked(const void* r, const void* k, const void* v, const void* lw,
                           const void* u, const float* S0, void* y, float* S_fin,
                           float* states, int B, int Tlen, int H, int c, Strides rs, Strides ks,
                           Strides vs, Strides ls, long long usb, long long ush,
                           cudaStream_t stream) {
  constexpr int EP = 16 / (int)sizeof(T), CL = cluster_size<HD>();
  const cudaError_t attr = allow_smem<T, HD, CL>();
  if (attr != cudaSuccess) return attr;
  bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(lw);
  const Strides all[4] = {rs, ks, vs, ls};
  for (const Strides& s : all) vec = vec && s.b % EP == 0 && s.t % EP == 0 && s.h % EP == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Tile<HD>::NC, H, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = Layout<T, HD, CL>((c + SB - 1) / SB * SB).total;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wkv_chunk_kernel<T, HD, CL>, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw), static_cast<const T*>(u), S0,
      static_cast<T*>(y), S_fin, states, Tlen, H, c, rs, ks, vs, ls, usb, ush, (int)vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_decode(const void* r, const void* k, const void* v, const void* lw,
                          const void* u, const float* S0, void* y, float* S_fin, float* states,
                          int B, int Tlen, int H, Strides rs, Strides ks, Strides vs, Strides ls,
                          long long usb, long long ush, cudaStream_t stream) {
  wkv_decode_kernel<T, HD><<<dim3(H, B), NTHREADS_D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), static_cast<const T*>(u), S0, static_cast<T*>(y), S_fin, states,
      Tlen, H, rs, ks, vs, ls, usb, ush, (int)aligned16(S0));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
                   const float* S0, void* y, float* S_fin, float* states, int B, int Tlen, int H,
                   int c, Strides rs, Strides ks, Strides vs, Strides ls, long long usb,
                   long long ush, cudaStream_t st) {
  if (c == 1)
    return launch_decode<T, HD>(r, k, v, lw, u, S0, y, S_fin, states, B, Tlen, H, rs, ks, vs, ls,
                                usb, ush, st);
  return launch_chunked<T, HD>(r, k, v, lw, u, S0, y, S_fin, states, B, Tlen, H, c, rs, ks, vs,
                               ls, usb, ush, st);
}

template <typename T>
cudaError_t launch_hd(int HD, const void* r, const void* k, const void* v, const void* lw,
                      const void* u, const float* S0, void* y, float* S_fin, float* states,
                      int B, int Tlen, int H, int c, Strides rs, Strides ks, Strides vs,
                      Strides ls, long long usb, long long ush, cudaStream_t st) {
#define WKV_CASE(D)                                                                           \
  case D:                                                                                     \
    return launch<T, D>(r, k, v, lw, u, S0, y, S_fin, states, B, Tlen, H, c, rs, ks, vs, ls, \
                        usb, ush, st);
  switch (HD) {
    WKV_CASE(8)
    WKV_CASE(16)
    WKV_CASE(32)
    WKV_CASE(64)
#undef WKV_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Once per kernel instance and device: allow the backward's shared memory
// at the longest chunk.
template <typename T, int HD>
cudaError_t allow_bwd_smem() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(wkv_bwd_state_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(state_smem_floats<HD>(MAX_CHUNK) * sizeof(float)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_bwd_chunk_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(BwdLayout<HD>(MAX_CHUNK).total * sizeof(float)));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
                       const void* dy, const float* states, const float* S_fin,
                       const float* dS_fin, void* dr, void* dk, void* dv, void* dlw, float* du,
                       float* dS0, float* work, int B, int Tlen, int H, int c, long long usb,
                       long long ush, cudaStream_t st) {
  cudaError_t err = allow_bwd_smem<T, HD>();
  if (err != cudaSuccess) return err;
  const int cp = (c + SB - 1) / SB * SB, nch = Tlen / c;
  const size_t slots = (size_t)B * H * nch;
  float* dS = work;                           // (B, H, T/c, HD, HD): G, then dS
  float* et = dS + slots * HD * HD;           // (B, H, T/c, HD): 2^tot
  float* du_part = et + slots * HD;           // (B, H, T/c, HD)
  const dim3 grid(nch, H, B);
  const T* r_ = static_cast<const T*>(r);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* lw_ = static_cast<const T*>(lw);
  const T* dy_ = static_cast<const T*>(dy);
  wkv_bwd_state_kernel<T, HD><<<grid, NTHREADS_B, state_smem_floats<HD>(cp) * sizeof(float), st>>>(
      r_, k_, v_, lw_, dy_, dS, et, du_part, Tlen, H, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv_bwd_scan_kernel<<<dim3((HD * HD / 4 + SCAN_THREADS - 1) / SCAN_THREADS, H, B),
                        SCAN_THREADS, 0, st>>>(dS, et, du_part, dS_fin, dS0, du, nch, HD);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv_bwd_chunk_kernel<T, HD><<<grid, NTHREADS_B, BwdLayout<HD>(cp).total * sizeof(float), st>>>(
      r_, k_, v_, lw_, static_cast<const T*>(u), dy_, states, dS_fin ? S_fin : nullptr, dS,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dlw), Tlen,
      H, c, usb, ush);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_hd(int HD, const void* r, const void* k, const void* v, const void* lw,
                          const void* u, const void* dy, const float* states, const float* S_fin,
                          const float* dS_fin, void* dr, void* dk, void* dv, void* dlw,
                          float* du, float* dS0, float* work, int B, int Tlen, int H, int c,
                          long long usb, long long ush, cudaStream_t st) {
#define WKV_BWD_CASE(D)                                                                       \
  case D:                                                                                     \
    return launch_bwd<T, D>(r, k, v, lw, u, dy, states, S_fin, dS_fin, dr, dk, dv, dlw, du,   \
                            dS0, work, B, Tlen, H, c, usb, ush, st);
  switch (HD) {
    WKV_BWD_CASE(8)
    WKV_BWD_CASE(16)
    WKV_BWD_CASE(32)
    WKV_BWD_CASE(64)
#undef WKV_BWD_CASE
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
// c divides T and is at most 64; H, B <= 65535.  c == 1 takes the decode
// route; otherwise pairs of a head's CTAs share A (one CTA a head where
// hd <= 16).  states, null or (B, H, T/c, hd, hd) f32 contiguous, receives
// each chunk's entry state (S0 first), for the backward.
int wkv_chunked(const void* r, const void* k, const void* v, const void* lw, const void* u,
                const void* S0, void* y, void* S_fin, void* states, int dtype, int B, int T,
                int H, int hd,
                int c, long long rsb, long long rst, long long rsh, long long ksb, long long kst,
                long long ksh, long long vsb, long long vst, long long vsh, long long lsb,
                long long lst, long long lsh, long long usb, long long ush, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 0 || c > MAX_CHUNK || T % c != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaGetLastError();
  const Strides rs{rsb, rst, rsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh}, ls{lsb, lst, lsh};
  const float* s0 = static_cast<const float*>(S0);
  float* sf = static_cast<float*>(S_fin);
  float* sts = static_cast<float*>(states);
  cudaError_t err;
  if (dtype == F32)
    err = launch_hd<float>(hd, r, k, v, lw, u, s0, y, sf, sts, B, T, H, c, rs, ks, vs, ls, usb,
                           ush, st);
  else if (dtype == BF16)
    err = launch_hd<__nv_bfloat16>(hd, r, k, v, lw, u, s0, y, sf, sts, B, T, H, c, rs, ks, vs,
                                   ls, usb, ush, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The gradients of wkv_chunked's (y, S_fin) against dy and dS_fin (null for
// zeros): dr, dk, dv, dlw (B, T, H, hd) in the inputs' dtype, du (B, H, hd)
// f32 per (batch, head), dS0 (B, H, hd, hd) f32 or null.  r, k, v, lw and
// dy are (B, T, H, hd) contiguous, u as in wkv_chunked; states is the
// forward's (B, H, T/c, hd, hd) output and S_fin its final state (read only
// with dS_fin).  work is f32 scratch of B*H*(T/c)*(hd*hd + 2*hd) floats.
// Three kernels on the stream (G and the chunks' du; the dS scan; the
// chunks' gradients); H, B <= 65535.
int wkv_chunked_bwd(const void* r, const void* k, const void* v, const void* lw, const void* u,
                    const void* dy, const void* states, const void* S_fin, const void* dS_fin,
                    void* dr, void* dk, void* dv, void* dlw, void* du, void* dS0, void* work,
                    int dtype, int B, int T, int H, int hd, int c, long long usb, long long ush,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 0 || c > MAX_CHUNK || T % c != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaGetLastError();
  const float* sts = static_cast<const float*>(states);
  const float* sf = static_cast<const float*>(S_fin);
  const float* dsf = static_cast<const float*>(dS_fin);
  float* du_ = static_cast<float*>(du);
  float* ds0 = static_cast<float*>(dS0);
  float* wk = static_cast<float*>(work);
  cudaError_t err;
  if (dtype == F32)
    err = launch_bwd_hd<float>(hd, r, k, v, lw, u, dy, sts, sf, dsf, dr, dk, dv, dlw, du_, ds0,
                               wk, B, T, H, c, usb, ush, st);
  else if (dtype == BF16)
    err = launch_bwd_hd<__nv_bfloat16>(hd, r, k, v, lw, u, dy, sts, sf, dsf, dr, dk, dv, dlw, du_,
                                       ds0, wk, B, T, H, c, usb, ush, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
