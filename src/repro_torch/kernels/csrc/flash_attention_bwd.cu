// flash_attention_bwd — the gradient of flash_attention for Hopper.
//
// The reference has no Pallas backward: it differentiates the plain
// blocked attention repro/models/attention.py::attend_blocked with
// jax.value_and_grad (repro/launch/steps.py).  The port's forward is the
// CUDA kernel of flash_attention.cu, which autograd cannot see through, so
// this file gives its gradient.  For q (B, Sq, H, D), k, v (B, Sk, Hkv, D),
// the forward's output o and its cotangent do (both (B, Sq, H, D)), query
// head h reading kv head h / G (G = H / Hkv):
//
//   x    = (q . k) * scale                   scale = 1 / sqrt(D)
//   s    = cap * tanh(x / cap), or x         the forward's softcap
//   mask = k_pos < Sk, k_pos <= q_pos (causal, top-left aligned),
//          q_pos - k_pos < window            the forward's mask
//   P    = exp(s - lse) on visible pairs, 0 elsewhere
//   dP   = do . v
//   dS   = P * (dP - delta) * (1 - (s / cap)^2, or 1)
//   dq   = scale * dS k,  dk = scale * dS^T q,  dv = P^T do
//
// with lse the row's logsumexp over its visible keys and
// delta = rowsum(do * o), both in f32.  Three launches (four on the
// tensor cores), on one of two paths (the wrapper's ``bwd_path`` chooses
// by dtype and D alone):
//
// - "mma_sync" (bf16, D 64 or 128): the products on the tensor cores,
//   mma.sync m16n8k16 with f32 accumulators (its section below);
// - "cuda_cores" (f32, or bf16 at another D): every product in f32 on the
//   CUDA cores, the operands rounded to f32 from bf16 or read as f32, in
//   the launches that follow:
//
// 1. bwd_prep, one block per (b, h, 64 query rows): lse by one online pass
//    over the visible key tiles (the forward writes no logsumexp, so this
//    leaves flash_attention.cu as it is), and delta.
// 2. bwd_dkdv, one block per (b, kv head, 64 keys): k and v tiles stay in
//    shared memory; the block walks the G query heads of its kv head and,
//    for each, the query tiles that see its keys, recomputing P and dS
//    from lse and delta, and accumulates dk and dv in registers.  The sum
//    over the G heads is inside the block, so nothing is added across
//    blocks.
// 3. bwd_dq, one block per (b, h, 64 query rows): q and do stay in shared
//    memory; the block walks the visible key tiles and accumulates dq.
//
// No atomics: every output element is written once, by one thread, after
// sums in a fixed order, so two calls on the same inputs give the same
// bits (the trainer's bit-exact crash/resume depends on it).
//
// What bounds it on the H100: operations.  A causal starcoder2-3b layer
// (B 4, S 2048, H 24, D 128) does ~0.26 TFLOP of useful work over ~0.2 GB;
// both paths do 16 D flops a visible pair (the 10 D of the gradient plus
// the recomputed logits of prep and dq).  The CUDA-core path is the simple
// one: tiles of 64 x D in shared memory, rows padded to D + 1 floats
// (conflict-free column reads), each thread a 4 x 4 tile of logits and a
// 4 x D/16 tile of the accumulators.  The mma.sync path reads its
// fragments from padded bf16 tiles with plain 32-bit loads; wgmma, TMA,
// ldmatrix and the logsumexp from the forward are later work.
//
// Head dims: D a multiple of 8 up to 256 (tiles of 32, 64, 128 or 256
// columns, zero-padded; 32 rows a tile at 256).  All operands dense
// (B, S, heads, D); the wrapper makes them so.
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); launches on the caller's stream and
// returns the first failing launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // 16 x 16 threads

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;     // (B, H, Sq)
  float* delta;   // (B, H, Sq)
  float* part;    // mma path: (2, B, Sk, H, D) per-query-head dk, dv
  int B, Sq, Sk, H, Hkv, D;
  int causal, has_window, window;
  float scale, cap;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  if (i >= p.Sq || j >= p.Sk) return false;
  if (p.causal && j > i) return false;
  if (p.has_window && !((long long)i - j < (long long)p.window)) return false;
  return true;
}

// keys [lo, hi) that some row of [i0, i1) sees
__device__ __forceinline__ void key_range(const Params& p, int i0, int i1,
                                          int& lo, int& hi) {
  long long h = p.Sk;
  if (p.causal) h = min(h, (long long)i1);
  long long l = 0;
  if (p.has_window) l = max(0LL, (long long)i0 - (long long)p.window + 1);
  lo = (int)min(l, h);
  hi = (int)h;
}

// query rows [lo, hi) that see some key of [j0, j1)
__device__ __forceinline__ void query_range(const Params& p, int j0, int j1,
                                            int& lo, int& hi) {
  long long l = p.causal ? j0 : 0;
  long long h = p.Sq;
  if (p.has_window) {
    h = min(h, max(0LL, (long long)j1 - 1 + (long long)p.window));
  }
  lo = (int)min(l, h);
  hi = (int)h;
}

// rows [r0, r0 + BT) of head h of a dense (B, S, NH, D) tensor into a
// [BT][DT + 1] f32 tile; rows past S and columns past D are zero
template <typename T, int DT, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int h, int r0, int S, int NH,
                                          int D) {
  for (int e = threadIdx.x; e < BT * DT; e += kThreads) {
    const int r = e / DT, d = e % DT;
    const int s = r0 + r;
    float x = 0.f;
    if (s < S && d < D) {
      x = to_f(src[(((long long)b * S + s) * NH + h) * D + d]);
    }
    dst[r * (DT + 1) + d] = x;
  }
}

// the logit s of the forward and ds/dx (the softcap's derivative)
__device__ __forceinline__ float logit(const Params& p, float acc,
                                       float& dcap) {
  float x = acc * p.scale;
  dcap = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(x / p.cap);
    x = p.cap * t;
    dcap = 1.f - t * t;
  }
  return x;
}

// sum / max over the 16 lanes of a half warp (one row of the thread grid)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// s[a][b] = A[ty + 16 a] . Bt[tx + 16 b] and, when TWO, t[a][b] =
// C[ty + 16 a] . Dt[tx + 16 b], over DT columns of [BT][DT + 1] tiles
template <int DT, int BT, bool TWO>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bt,
                                          const float* C, const float* Dt,
                                          float (&s)[BT / 16][BT / 16],
                                          float (&t)[BT / 16][BT / 16]) {
  constexpr int R = BT / 16, LD = DT + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) s[a][b] = t[a][b] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < DT; ++d) {
    float av[R], bv[R], cv[R], dv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      av[a] = A[(ty + 16 * a) * LD + d];
      bv[a] = Bt[(tx + 16 * a) * LD + d];
      if (TWO) {
        cv[a] = C[(ty + 16 * a) * LD + d];
        dv[a] = Dt[(tx + 16 * a) * LD + d];
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int b = 0; b < R; ++b) {
        s[a][b] = fmaf(av[a], bv[b], s[a][b]);
        if (TWO) t[a][b] = fmaf(cv[a], dv[b], t[a][b]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1. lse and delta
// ---------------------------------------------------------------------------

template <typename T, int DT, int BT>
__global__ void __launch_bounds__(kThreads) bwd_prep(Params p) {
  constexpr int R = BT / 16, LD = DT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BT * LD;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BT;
  const int hk = h / (p.H / p.Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);

  // delta = rowsum(do * o): 16 lanes a row
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = i0 + ty + 16 * a;
    float acc = 0.f;
    if (i < p.Sq) {
      const long long base = (((long long)b * p.Sq + i) * p.H + h) * p.D;
      for (int d = tx; d < p.D; d += 16) {
        acc = fmaf(to_f(dout[base + d]), to_f(o[base + d]), acc);
      }
    }
    acc = half_sum(acc);
    if (tx == 0 && i < p.Sq) {
      p.delta[((long long)b * p.H + h) * p.Sq + i] = acc;
    }
  }

  load_tile<T, DT, BT>(Qs, q, b, h, i0, p.Sq, p.H, p.D);
  float m[R], l[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    m[a] = neg_inf();
    l[a] = 0.f;
  }
  int lo, hi;
  key_range(p, i0, min(i0 + BT, p.Sq), lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BT) {
    __syncthreads();
    load_tile<T, DT, BT>(Ks, k, b, hk, j0, p.Sk, p.Hkv, p.D);
    __syncthreads();
    float s[R][R], unused[R][R];
    tile_dots<DT, BT, false>(Qs, Ks, nullptr, nullptr, s, unused);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = i0 + ty + 16 * a;
      float bm = neg_inf();
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float dcap;
        const float x = logit(p, s[a][c], dcap);
        s[a][c] = visible(p, i, j0 + tx + 16 * c) ? x : neg_inf();
        bm = fmaxf(bm, s[a][c]);
      }
      bm = half_max(bm);
      const float mn = fmaxf(m[a], bm);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if (s[a][c] != neg_inf()) sum += __expf(s[a][c] - mn);
      }
      sum = half_sum(sum);
      const float alpha = mn == neg_inf() ? 1.f : __expf(m[a] - mn);
      l[a] = l[a] * alpha + sum;
      m[a] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = i0 + ty + 16 * a;
      // a row that sees no key gets P = 0 everywhere, whatever its lse
      if (i < p.Sq) {
        p.lse[((long long)b * p.H + h) * p.Sq + i] =
            l[a] > 0.f ? m[a] + logf(l[a]) : 0.f;
      }
    }
  }
}

// P and dS of the visible pairs of one (query tile, key tile), into
// [BT][BT + 1] tiles indexed [query][key]; the thread's pairs are rows
// ty + 16 a and keys tx + 16 c
template <int BT>
__device__ __forceinline__ void p_ds(const Params& p, int i0, int j0,
                                     float (&s)[BT / 16][BT / 16],
                                     const float (&dp)[BT / 16][BT / 16],
                                     const float* lse_s, const float* dl_s,
                                     float* Ps, float* dSs) {
  constexpr int R = BT / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int col = tx + 16 * c;
      float P = 0.f, dS = 0.f;
      if (visible(p, i0 + r, j0 + col)) {
        float dcap;
        const float x = logit(p, s[a][c], dcap);
        P = __expf(x - lse_s[r]);
        dS = P * (dp[a][c] - dl_s[r]) * dcap;
      }
      if (Ps != nullptr) Ps[r * (BT + 1) + col] = P;
      dSs[r * (BT + 1) + col] = dS;
    }
  }
}

template <int BT>
__device__ __forceinline__ void load_rows(const Params& p, int b, int h,
                                          int i0, float* lse_s,
                                          float* dl_s) {
  if (threadIdx.x < BT) {
    const int i = i0 + threadIdx.x;
    const long long at = ((long long)b * p.H + h) * p.Sq + i;
    lse_s[threadIdx.x] = i < p.Sq ? p.lse[at] : 0.f;
    dl_s[threadIdx.x] = i < p.Sq ? p.delta[at] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 2. dk, dv
// ---------------------------------------------------------------------------

template <typename T, int DT, int BT>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(Params p) {
  constexpr int R = BT / 16, C = DT / 16, LD = DT + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* Os = Qs + BT * LD;          // do
  float* Ps = Os + BT * LD;
  float* dSs = Ps + BT * (BT + 1);
  float* lse_s = dSs + BT * (BT + 1);
  float* dl_s = lse_s + BT;
  const int b = blockIdx.z, hk = blockIdx.y, j0 = blockIdx.x * BT;
  const int G = p.H / p.Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);

  load_tile<T, DT, BT>(Ks, static_cast<const T*>(p.k), b, hk, j0, p.Sk,
                       p.Hkv, p.D);
  load_tile<T, DT, BT>(Vs, static_cast<const T*>(p.v), b, hk, j0, p.Sk,
                       p.Hkv, p.D);
  float dk[R][C], dv[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int c = 0; c < C; ++c) dk[a][c] = dv[a][c] = 0.f;
  }
  int lo, hi;
  query_range(p, j0, min(j0 + BT, p.Sk), lo, hi);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int i0 = lo; i0 < hi; i0 += BT) {
      __syncthreads();
      load_tile<T, DT, BT>(Qs, q, b, h, i0, p.Sq, p.H, p.D);
      load_tile<T, DT, BT>(Os, dout, b, h, i0, p.Sq, p.H, p.D);
      load_rows<BT>(p, b, h, i0, lse_s, dl_s);
      __syncthreads();
      float s[R][R], dp[R][R];
      tile_dots<DT, BT, true>(Qs, Ks, Os, Vs, s, dp);
      p_ds<BT>(p, i0, j0, s, dp, lse_s, dl_s, Ps, dSs);
      __syncthreads();
      // dv[j][d] += P[i][j] do[i][d], dk[j][d] += dS[i][j] q[i][d]
#pragma unroll 2
      for (int i = 0; i < BT; ++i) {
        float pa[R], sa[R], oc[C], qc[C];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pa[a] = Ps[i * (BT + 1) + ty + 16 * a];
          sa[a] = dSs[i * (BT + 1) + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          oc[c] = Os[i * LD + tx + 16 * c];
          qc[c] = Qs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv[a][c] = fmaf(pa[a], oc[c], dv[a][c]);
            dk[a][c] = fmaf(sa[a], qc[c], dk[a][c]);
          }
        }
      }
    }
  }
  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= p.Sk) continue;
    const long long base = (((long long)b * p.Sk + j) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) {
        store(dkp + base + d, dk[a][c] * p.scale);
        store(dvp + base + d, dv[a][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq
// ---------------------------------------------------------------------------

template <typename T, int DT, int BT>
__global__ void __launch_bounds__(kThreads) bwd_dq(Params p) {
  constexpr int R = BT / 16, C = DT / 16, LD = DT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + BT * LD;
  float* Ks = Os + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dSs = Vs + BT * LD;
  float* lse_s = dSs + BT * (BT + 1);
  float* dl_s = lse_s + BT;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BT;
  const int hk = h / (p.H / p.Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  load_tile<T, DT, BT>(Qs, static_cast<const T*>(p.q), b, h, i0, p.Sq, p.H,
                       p.D);
  load_tile<T, DT, BT>(Os, static_cast<const T*>(p.dout), b, h, i0, p.Sq,
                       p.H, p.D);
  load_rows<BT>(p, b, h, i0, lse_s, dl_s);
  float dq[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int c = 0; c < C; ++c) dq[a][c] = 0.f;
  }
  int lo, hi;
  key_range(p, i0, min(i0 + BT, p.Sq), lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BT) {
    __syncthreads();
    load_tile<T, DT, BT>(Ks, k, b, hk, j0, p.Sk, p.Hkv, p.D);
    load_tile<T, DT, BT>(Vs, v, b, hk, j0, p.Sk, p.Hkv, p.D);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dots<DT, BT, true>(Qs, Ks, Os, Vs, s, dp);
    p_ds<BT>(p, i0, j0, s, dp, lse_s, dl_s, nullptr, dSs);
    __syncthreads();
    // dq[i][d] += dS[i][j] k[j][d]
#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      float sa[R], kc[C];
#pragma unroll
      for (int a = 0; a < R; ++a) sa[a] = dSs[(ty + 16 * a) * (BT + 1) + j];
#pragma unroll
      for (int c = 0; c < C; ++c) kc[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int c = 0; c < C; ++c) dq[a][c] = fmaf(sa[a], kc[c], dq[a][c]);
      }
    }
  }
  T* dqp = static_cast<T*>(p.dq);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= p.Sq) continue;
    const long long base = (((long long)b * p.Sq + i) * p.H + h) * p.D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) store(dqp + base + d, dq[a][c] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int DT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr int BT = DT == 256 ? 32 : 64;
  constexpr int LD = DT + 1;
  const size_t prep = sizeof(float) * 2 * BT * LD;
  const size_t dkdv = sizeof(float) * (4 * BT * LD + 2 * BT * (BT + 1) +
                                       2 * BT);
  const size_t dq = sizeof(float) * (4 * BT * LD + BT * (BT + 1) + 2 * BT);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_prep<T, DT, BT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)prep)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_dkdv<T, DT, BT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dkdv)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_dq<T, DT, BT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dq)) != cudaSuccess) {
    return e;
  }
  const dim3 rows((p.Sq + BT - 1) / BT, p.H, p.B);
  bwd_prep<T, DT, BT><<<rows, kThreads, prep, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (p.Sk > 0) {
    const dim3 keys((p.Sk + BT - 1) / BT, p.Hkv, p.B);
    bwd_dkdv<T, DT, BT><<<keys, kThreads, dkdv, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  bwd_dq<T, DT, BT><<<rows, kThreads, dq, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, cudaStream_t st) {
  if (p.D <= 32) return launch<T, 32>(p, st);
  if (p.D <= 64) return launch<T, 64>(p, st);
  if (p.D <= 128) return launch<T, 128>(p, st);
  return launch<T, 256>(p, st);
}

// ---------------------------------------------------------------------------
// mma.sync path: bf16 operands, D 64 or 128
// ---------------------------------------------------------------------------
//
// The products on the tensor cores: mma.sync m16n8k16, bf16 operands
// and f32 accumulators, four warps a block.  Tiles live in shared memory
// as bf16 rows padded by 8 elements (16-byte rows, conflict-free fragment
// reads); a fragment whose pairs run along a row is read with 32-bit
// loads, one whose pairs run down a column with ldmatrix .trans.  P and dS
// are rounded to bf16 for their products (f32 everywhere else), and a C
// fragment of two n-tiles is an A fragment of one k-step, so P and dS
// never leave the registers.
//
// - prep: 64 query rows a block, 16 a warp; S = Q K^T tile by tile with
//   the online max and sum in registers, reduced over the four lanes of a
//   row by shuffles.
// - dk/dv: one block per (b, query head, 64 keys), 16 keys a warp; for
//   each tile of 32 query rows that sees the keys, S^T = K Q^T and
//   dP^T = V dO^T (so P^T and dS^T come out in the warp's registers),
//   then dV += P^T dO and dK += dS^T Q.  Each query head writes its share
//   in f32 to scratch, and bwd_reduce_mma sums the G shares of a kv head
//   in head order: G times the blocks of one block per kv head, which
//   left a causal layer's first key blocks with G x all the queries.
// - dq: 64 query rows a block, 16 a warp; for each visible tile of 64
//   keys, S and dP, then dQ += dS K.

constexpr int kMmaThreads = 128;   // four warps

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16) of a row-major tile: rows r0.., columns k0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* X,
                                       int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = X + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// B fragment (16 x 8) of a tile stored [n][k]: n0.., k0..
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* Y, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = Y + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// B fragment (16 x 8) of a tile stored [k][n] (rows along k): k0..,
// n0.., by ldmatrix .trans (lanes 0-15 give the addresses of rows
// k0..k0+15, 16-byte aligned)
__device__ __forceinline__ void frag_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* X, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(X + (k0 + (lane & 15)) * ld + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// the A fragment of k-step kk from the C fragments of n-tiles 2kk, 2kk+1
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], float (&c)[N][4],
                                       int kk) {
  a[0] = pack2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows [r0, r0 + R) of head h of a dense (B, S, NH, D) bf16 tensor into
// X[R][D + 8], 16 bytes a load; rows past S are zero
template <int R, int D>
__device__ __forceinline__ void load_rows16(bf16* X, const bf16* src, int b,
                                            int h, int r0, int S, int NH) {
  constexpr int V = D / 8, LD = D + 8;
  for (int e = threadIdx.x; e < R * V; e += kMmaThreads) {
    const int r = e / V, c = (e % V) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      val = *reinterpret_cast<const uint4*>(
          src + (((long long)b * S + r0 + r) * NH + h) * D + c);
    }
    *reinterpret_cast<uint4*>(X + r * LD + c) = val;
  }
}

template <int R>
__device__ __forceinline__ void load_rows_mma(const Params& p, int b, int h,
                                              int i0, float* lse_s,
                                              float* dl_s) {
  for (int r = threadIdx.x; r < R; r += kMmaThreads) {
    const int i = i0 + r;
    const long long at = ((long long)b * p.H + h) * p.Sq + i;
    lse_s[r] = i < p.Sq ? p.lse[at] : 0.f;
    dl_s[r] = i < p.Sq ? p.delta[at] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_prep_mma(Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BQ;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, iw = warp * 16;
  const bf16* o = static_cast<const bf16*>(p.o);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  // delta = rowsum(do * o): a warp a row, 16 rows a warp
  for (int r = iw; r < iw + 16; ++r) {
    const int i = i0 + r;
    float acc = 0.f;
    if (i < p.Sq) {
      const long long base = (((long long)b * p.Sq + i) * p.H + h) * D;
      for (int d = lane; d < D; d += 32) {
        acc = fmaf(__bfloat162float(dout[base + d]),
                   __bfloat162float(o[base + d]), acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0 && i < p.Sq) {
      p.delta[((long long)b * p.H + h) * p.Sq + i] = acc;
    }
  }

  load_rows16<BQ, D>(Qs, static_cast<const bf16*>(p.q), b, h, i0, p.Sq, p.H);
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  int lo, hi;
  key_range(p, i0, min(i0 + BQ, p.Sq), lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();
    load_rows16<BK, D>(Ks, static_cast<const bf16*>(p.k), b, hk, j0, p.Sk,
                       p.Hkv);
    __syncthreads();
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      frag_a(a, Qs, LD, iw, 16 * ks);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, Ks, LD, 8 * n, 16 * ks);
        mma16816(s[n], a, b0, b1);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + iw + g + 8 * half;
      float bm = neg_inf();
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float dcap;
          const float x = logit(p, s[n][2 * half + e], dcap);
          const bool vis = visible(p, i, j0 + 8 * n + 2 * t + e);
          s[n][2 * half + e] = vis ? x : neg_inf();
          bm = fmaxf(bm, s[n][2 * half + e]);
        }
      }
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
      const float mn = fmaxf(m[half], bm);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[n][2 * half + e];
          if (x != neg_inf()) sum += __expf(x - mn);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = mn == neg_inf() ? 1.f : __expf(m[half] - mn);
      l[half] = l[half] * alpha + sum;
      m[half] = mn;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + iw + g + 8 * half;
      if (i < p.Sq) {
        p.lse[((long long)b * p.H + h) * p.Sq + i] =
            l[half] > 0.f ? m[half] + logf(l[half]) : 0.f;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkdv_mma(Params p) {
  constexpr int BK = 64, BQ = 32, LD = D + 8, NT = D / 8, NQ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* Os = Qs + BQ * LD;           // do
  float* lse_s = reinterpret_cast<float*>(Os + BQ * LD);
  float* dl_s = lse_s + BQ;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BK;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, jw = warp * 16;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  load_rows16<BK, D>(Ks, static_cast<const bf16*>(p.k), b, hk, j0, p.Sk,
                     p.Hkv);
  load_rows16<BK, D>(Vs, static_cast<const bf16*>(p.v), b, hk, j0, p.Sk,
                     p.Hkv);
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
  int lo, hi;
  query_range(p, j0, min(j0 + BK, p.Sk), lo, hi);
  for (int i0 = lo; i0 < hi; i0 += BQ) {
    __syncthreads();
    load_rows16<BQ, D>(Qs, q, b, h, i0, p.Sq, p.H);
    load_rows16<BQ, D>(Os, dout, b, h, i0, p.Sq, p.H);
    load_rows_mma<BQ>(p, b, h, i0, lse_s, dl_s);
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BQ queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ak[4], av[4];
      frag_a(ak, Ks, LD, jw, 16 * ks);
      frag_a(av, Vs, LD, jw, 16 * ks);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, Qs, LD, 8 * n, 16 * ks);
        mma16816(st[n], ak, b0, b1);
        frag_b(b0, b1, Os, LD, 8 * n, 16 * ks);
        mma16816(dpt[n], av, b0, b1);
      }
    }
    // P^T and dS^T in place: element e of n-tile n is key jw + g (+8 for
    // e >= 2), query 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * t + (e & 1);
        const int key = j0 + jw + g + (e >= 2 ? 8 : 0);
        float P = 0.f, dS = 0.f;
        if (visible(p, i0 + r, key)) {
          float dcap;
          const float x = logit(p, st[n][e], dcap);
          P = __expf(x - lse_s[r]);
          dS = P * (dpt[n][e] - dl_s[r]) * dcap;
        }
        st[n][e] = P;
        dpt[n][e] = dS;
      }
    }
    // dV += P^T dO and dK += dS^T Q, dO and Q read down their columns
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a<NQ>(ap, st, kk);
      c_to_a<NQ>(as, dpt, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_bt(b0, b1, Os, LD, 16 * kk, 8 * n);
        mma16816(dv[n], ap, b0, b1);
        frag_bt(b0, b1, Qs, LD, 16 * kk, 8 * n);
        mma16816(dk[n], as, b0, b1);
      }
    }
  }
  // this query head's share, in f32: (2, B, Sk, H, D), summed over the G
  // heads of the kv head by bwd_reduce_mma
  const long long plane = (long long)p.B * p.Sk * p.H * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = j0 + jw + g + 8 * half;
    if (key >= p.Sk) continue;
    float* base = p.part + (((long long)b * p.Sk + key) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(base + d) =
          make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<float2*>(base + plane + d) =
          make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// dk = scale * sum over the G query heads of the kv head, dv = the sum,
// the heads in order (no atomics); one thread an element pair
template <int D>
__global__ void bwd_reduce_mma(Params p) {
  const long long pairs = (long long)p.B * p.Sk * p.Hkv * (D / 2);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pairs) return;
  const int G = p.H / p.Hkv;
  const int d = 2 * (int)(e % (D / 2));
  const long long row = e / (D / 2);            // (b, key, kv head)
  const int hk = (int)(row % p.Hkv);
  const long long bk = row / p.Hkv;             // b * Sk + key
  const long long plane = (long long)p.B * p.Sk * p.H * D;
  const float* src = p.part + (bk * p.H + (long long)hk * G) * D + d;
  float2 k2 = make_float2(0.f, 0.f), v2 = make_float2(0.f, 0.f);
  for (int gh = 0; gh < G; ++gh) {
    const float2 a = *reinterpret_cast<const float2*>(src + gh * D);
    const float2 c = *reinterpret_cast<const float2*>(src + plane + gh * D);
    k2.x += a.x;
    k2.y += a.y;
    v2.x += c.x;
    v2.y += c.y;
  }
  const long long out = row * D + d;
  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dk) + out) =
      pack2(k2.x * p.scale, k2.y * p.scale);
  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dv) + out) =
      pack2(v2.x, v2.y);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma(Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8, NT = D / 8, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BQ * LD;
  bf16* Ks = Os + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* dl_s = lse_s + BQ;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BQ;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, iw = warp * 16;
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);

  load_rows16<BQ, D>(Qs, static_cast<const bf16*>(p.q), b, h, i0, p.Sq, p.H);
  load_rows16<BQ, D>(Os, static_cast<const bf16*>(p.dout), b, h, i0, p.Sq,
                     p.H);
  load_rows_mma<BQ>(p, b, h, i0, lse_s, dl_s);
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  int lo, hi;
  key_range(p, i0, min(i0 + BQ, p.Sq), lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();
    load_rows16<BK, D>(Ks, k, b, hk, j0, p.Sk, p.Hkv);
    load_rows16<BK, D>(Vs, v, b, hk, j0, p.Sk, p.Hkv);
    __syncthreads();
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t aq[4], ao[4];
      frag_a(aq, Qs, LD, iw, 16 * ks);
      frag_a(ao, Os, LD, iw, 16 * ks);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, Ks, LD, 8 * n, 16 * ks);
        mma16816(s[n], aq, b0, b1);
        frag_b(b0, b1, Vs, LD, 8 * n, 16 * ks);
        mma16816(dp[n], ao, b0, b1);
      }
    }
    // dS in place: element e of n-tile n is query iw + g (+8 for e >= 2),
    // key 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = iw + g + (e >= 2 ? 8 : 0);
        float dS = 0.f;
        if (visible(p, i0 + r, j0 + 8 * n + 2 * t + (e & 1))) {
          float dcap;
          const float x = logit(p, s[n][e], dcap);
          dS = __expf(x - lse_s[r]) * (dp[n][e] - dl_s[r]) * dcap;
        }
        s[n][e] = dS;
      }
    }
    // dQ += dS K, K read down its columns
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a<NB>(a, s, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_bt(b0, b1, Ks, LD, 16 * kk, 8 * n);
        mma16816(dq[n], a, b0, b1);
      }
    }
  }
  bf16* dqp = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + iw + g + 8 * half;
    if (i >= p.Sq) continue;
    const long long base = (((long long)b * p.Sq + i) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dqp + base + 8 * n + 2 * t) =
          pack2(dq[n][2 * half] * p.scale, dq[n][2 * half + 1] * p.scale);
    }
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t st) {
  constexpr int LD = D + 8;
  const size_t prep = sizeof(bf16) * 2 * 64 * LD;
  const size_t dkdv = sizeof(bf16) * (2 * 64 * LD + 2 * 32 * LD) +
                      sizeof(float) * 2 * 32;
  const size_t dq = sizeof(bf16) * 4 * 64 * LD + sizeof(float) * 2 * 64;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_prep_mma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)prep)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_dkdv_mma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dkdv)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_dq_mma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dq)) != cudaSuccess) {
    return e;
  }
  const dim3 rows((p.Sq + 63) / 64, p.H, p.B);
  bwd_prep_mma<D><<<rows, kMmaThreads, prep, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (p.Sk > 0) {
    const dim3 keys((p.Sk + 63) / 64, p.H, p.B);
    bwd_dkdv_mma<D><<<keys, kMmaThreads, dkdv, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const long long pairs = (long long)p.B * p.Sk * p.Hkv * (D / 2);
    bwd_reduce_mma<D><<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  bwd_dq_mma<D><<<rows, kMmaThreads, dq, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    void* part, int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
    int has_window,
    int window, float scale, float cap, int dtype, int path, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      D < 8 || D > 256 || D % 8 != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1 || (Sk > 0 && part == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    if (D == 64) return (int)launch_mma<64>(p, s);
    if (D == 128) return (int)launch_mma<128>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? (int)launch_d<bf16>(p, s) : (int)launch_d<float>(p, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
