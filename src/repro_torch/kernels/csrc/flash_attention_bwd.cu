// flash_attention_bwd — the gradient of flash_attention for Hopper.
//
// The reference has no Pallas backward: it differentiates the plain
// blocked attention repro/models/attention.py::attend_blocked with
// jax.value_and_grad (repro/launch/steps.py).  The port's forward is the
// CUDA kernel of flash_attention.cu, which autograd cannot see through, so
// this file gives its gradient.  For q (B, Sq, H, D), k, v (B, Sk, Hkv, D),
// the forward's output o, its logsumexp lse2 and the cotangent do (o and
// do (B, Sq, H, D)), query head h reading kv head h / G (G = H / Hkv):
//
//   x    = (q . k) * scale                   scale = 1 / sqrt(D)
//   s    = cap * tanh(x / cap), or x         the forward's softcap
//   mask = k_pos < Sk, k_pos <= q_pos (causal, top-left aligned),
//          q_pos - k_pos < window            the forward's mask
//   P    = 2^(s log2(e) - lse2) on visible pairs, 0 elsewhere
//   dP   = do . v
//   dS   = P * (dP - delta) * (1 - (s / cap)^2, or 1)
//   dq   = scale * dS k,  dk = scale * dS^T q,  dv = P^T do
//
// lse2 is the row's logsumexp over its visible keys in log2 units, an f32
// (B, H, Sq) that the forward writes (flash_attention.cu's header: log2 of
// the sum of 2^(s log2(e)), NEG_INF for a row that sees no key, whose P is
// 0 through the mask).  delta = rowsum(do * o), f32, is the first launch
// of either path (bwd_delta, bound by bytes).  The wrapper's ``bwd_path``
// chooses the path by dtype and D alone:
//
// - "wgmma" (bf16, D 64 or 128): the products on the tensor cores by
//   wgmma, the tiles brought by TMA (its section below);
// - "cuda_cores" (f32, or bf16 at another D): every product in f32 on the
//   CUDA cores, the operands rounded to f32 from bf16 or read as f32:
//   bwd_dkdv, one block per (b, kv head, 64 keys) with k and v in shared
//   memory, walking the G query heads of its kv head and their query
//   tiles (so the sum over the G heads is inside the block), and bwd_dq,
//   one block per (b, h, 64 query rows) walking the visible key tiles.
//   Tiles of 64 x D in shared memory, rows padded to D + 1 floats
//   (conflict-free column reads), each thread a 4 x 4 tile of logits and
//   a 4 x D/16 tile of the accumulators (32 rows a tile at D 256).
//
// No atomics: every output element is written once, by one thread, after
// sums in a fixed order, so two calls on the same inputs give the same
// bits (the trainer's bit-exact crash/resume depends on it).
//
// What bounds it on the H100: operations.  A causal starcoder2-3b layer
// (B 4, S 2048, H 24, D 128) does ~0.26 TFLOP of useful work (10 D flops a
// visible pair) over ~0.2 GB.  The wgmma path does 14 D: dk/dv recompute
// S^T and dP^T (4 D) for their two products (4 D), dq recomputes S and dP
// (4 D) for its one (2 D).
//
// Head dims: D a multiple of 8 up to 256 (the CUDA-core tiles hold 32, 64,
// 128 or 256 columns, zero-padded).  All operands dense (B, S, heads, D)
// and 16-byte aligned; the wrapper makes them so (TMA maps need 16-byte
// strides).
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); launches on the caller's stream and
// returns the first failing launch's cudaError_t.  The TMA tensor-map
// encoder comes from libcuda through cudaGetDriverEntryPoint, so nothing
// links -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // CUDA cores: 16 x 16 threads
constexpr float kLog2e = 1.4426950408889634f;

// What the CUDA-core kernels and bwd_delta read, and nothing else, taken
// by value: the code ptxas makes of them is sensitive to the struct they
// take (one unread pointer more in its middle, or taking it as
// __grid_constant__, slows them by a half at gemma2-9b's local layer:
// tools/bwd_cuda_cores_probe.py, tools/bwd_variants.py).
struct CoreParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // (B, H, Sq): the forward's, log2 units
  float* delta;      // (B, H, Sq)
  int B, Sq, Sk, H, Hkv, D;
  int causal, has_window, window;
  float scale, cap;
};

// the wgmma path's
struct Params : CoreParams {
  float* part;       // groups > 1: (2, groups, B, Sk, Hkv, D)
  int groups;        // the groups a kv head's G query heads form
  // the epilogue's constants (log2 units, as the forward's)
  float qk2;         // scale * log2(e)
  float cap_in;      // 2 log2(e) scale / cap
  float cap_out;     // cap * log2(e)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const CoreParams& p, int i, int j) {
  if (i >= p.Sq || j >= p.Sk) return false;
  if (p.causal && j > i) return false;
  if (p.has_window && !((long long)i - j < (long long)p.window)) return false;
  return true;
}

// keys [lo, hi) that some row of [i0, i1) sees
__device__ __forceinline__ void key_range(const CoreParams& p, int i0,
                                          int i1, int& lo, int& hi) {
  long long h = p.Sk;
  if (p.causal) h = min(h, (long long)i1);
  long long l = 0;
  if (p.has_window) l = max(0LL, (long long)i0 - (long long)p.window + 1);
  lo = (int)min(l, h);
  hi = (int)h;
}

// query rows [lo, hi) that see some key of [j0, j1)
__device__ __forceinline__ void query_range(const CoreParams& p, int j0,
                                            int j1, int& lo, int& hi) {
  long long l = p.causal ? j0 : 0;
  long long h = p.Sq;
  if (p.has_window) {
    h = min(h, max(0LL, (long long)j1 - 1 + (long long)p.window));
  }
  lo = (int)min(l, h);
  hi = (int)h;
}

// 8 consecutive elements as floats (16-byte aligned)
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// 2^x on the special-function unit, one instruction (max relative error
// ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sum / max over the 16 lanes of a half warp
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// delta = rowsum(do * o), both paths: 16 lanes a (b, i, h) row, 16-byte
// loads; bound by bytes (do and o read once)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_delta(CoreParams p) {
  constexpr int EPV = 8;   // elements a load8
  const long long rows = (long long)p.B * p.Sq * p.H;
  const long long row = (long long)blockIdx.x * 16 + (threadIdx.x >> 4);
  const int lane = threadIdx.x & 15;
  float acc = 0.f;
  if (row < rows) {
    const T* o = static_cast<const T*>(p.o) + row * p.D;
    const T* dout = static_cast<const T*>(p.dout) + row * p.D;
    for (int c = lane * EPV; c < p.D; c += 16 * EPV) {
      float x[8], y[8];
      load8(o + c, x);
      load8(dout + c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
    }
  }
  acc = half_sum(acc);
  if (lane == 0 && row < rows) {
    const int h = (int)(row % p.H);
    const long long bi = row / p.H;      // b * Sq + i
    const int i = (int)(bi % p.Sq);
    const long long b = bi / p.Sq;
    p.delta[(b * p.H + h) * p.Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// CUDA cores
// ---------------------------------------------------------------------------

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

// the logit s of the forward (natural units, tanhf) and ds/dx
__device__ __forceinline__ float logit(const CoreParams& p, float acc,
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

// P and dS of the visible pairs of one (query tile, key tile), into
// [BT][BT + 1] tiles indexed [query][key]; the thread's pairs are rows
// ty + 16 a and keys tx + 16 c
template <int BT>
__device__ __forceinline__ void p_ds(const CoreParams& p, int i0, int j0,
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
        P = ex2(x * kLog2e - lse_s[r]);
        dS = P * (dp[a][c] - dl_s[r]) * dcap;
      }
      if (Ps != nullptr) Ps[r * (BT + 1) + col] = P;
      dSs[r * (BT + 1) + col] = dS;
    }
  }
}

template <int BT>
__device__ __forceinline__ void load_rows(const CoreParams& p, int b, int h,
                                          int i0, float* lse_s,
                                          float* dl_s) {
  if (threadIdx.x < BT) {
    const int i = i0 + threadIdx.x;
    const long long at = ((long long)b * p.H + h) * p.Sq + i;
    lse_s[threadIdx.x] = i < p.Sq ? p.lse[at] : 0.f;
    dl_s[threadIdx.x] = i < p.Sq ? p.delta[at] : 0.f;
  }
}

template <typename T, int DT, int BT>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(CoreParams p) {
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

template <typename T, int DT, int BT>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(CoreParams p) {
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

template <typename T>
cudaError_t launch_delta(const CoreParams& p, cudaStream_t st) {
  const long long rows = (long long)p.B * p.Sq * p.H;
  bwd_delta<T><<<(unsigned)((rows + 15) / 16), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t launch_cores(const CoreParams& p, cudaStream_t st) {
  constexpr int BT = DT == 256 ? 32 : 64;
  constexpr int LD = DT + 1;
  constexpr size_t dkdv = sizeof(float) * (4 * BT * LD + 2 * BT * (BT + 1) +
                                           2 * BT);
  constexpr size_t dq = sizeof(float) * (4 * BT * LD + BT * (BT + 1) +
                                         2 * BT);
  // once per instantiation, before any CUDA graph capture of the launch
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv<T, DT, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkdv);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(bwd_dq<T, DT, BT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dq);
  }();
  if (attr != cudaSuccess) return attr;
  cudaError_t e = launch_delta<T>(p, st);
  if (e != cudaSuccess) return e;
  const dim3 rows((p.Sq + BT - 1) / BT, p.H, p.B);
  if (p.Sk > 0) {
    const dim3 keys((p.Sk + BT - 1) / BT, p.Hkv, p.B);
    bwd_dkdv<T, DT, BT><<<keys, kThreads, dkdv, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  bwd_dq<T, DT, BT><<<rows, kThreads, dq, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cores_d(const CoreParams& p, cudaStream_t st) {
  if (p.D <= 32) return launch_cores<T, 32>(p, st);
  if (p.D <= 64) return launch_cores<T, 64>(p, st);
  if (p.D <= 128) return launch_cores<T, 128>(p, st);
  return launch_cores<T, 256>(p, st);
}

// ---------------------------------------------------------------------------
// wgmma path: bf16, D 64 or 128
// ---------------------------------------------------------------------------
//
// Two kernels on the forward's Hopper pieces (flash_attention.cu's wgmma
// prefill), each block three warpgroups: a producer (one warp keeps TMA
// loads in flight behind "full" and "empty" mbarriers; setmaxnreg gives
// its registers to the others) and two consumer warpgroups that run the
// products.  Tiles live in shared memory in the 128-byte-swizzled layout
// TMA writes and wgmma reads: per 64 columns of D an atom column of
// rows x 128 bytes, every box 64 columns x 64 rows, rows past S zero.
//
// Per tile, each consumer warpgroup issues its two shared-memory products
// only after the other has issued its own (ping-pong, turn_wait /
// turn_pass), so one's element-wise work overlaps the other's products;
// the element-wise work (P, dS) is straight-line code, its softcap and
// mask chosen once a tile (grads_t, grads): a branch per element keeps the
// compiler from interleaving the elements, and costs more than all the
// products together (tools/bwd_variants.py's "branchy").
//
// - bwd_dkdv_wgmma: one block per (b, kv head, head group, 128 keys), 64
//   keys a consumer warpgroup, k and v loaded once.  The producer walks
//   the group's query heads in order and, for each, the 64-row query
//   tiles that see the block's keys (query_range), bringing q, do and
//   their rows' lse2 and delta into a two-stage ring.  Per tile, S^T =
//   K Q^T and dP^T = V dO^T (shared-memory wgmma, m64n64k16: S^T rather
//   than S puts P^T and dS^T in the register-A layout), P^T and dS^T in
//   registers (rounded to bf16 for their products), then dV += P^T dO and
//   dK += dS^T Q (register-A wgmma against the MN-major q and do tiles,
//   as the forward's P V reads v).  dK and dV (2 x D / 2 f32 a thread)
//   stay in registers across the group's heads.  With one group the
//   block writes dk and dv in bf16; else each group writes its f32 share
//   to `part` and bwd_reduce sums the groups in order.  The wrapper
//   chooses the fewest groups that give the grid >= 2 blocks an SM.
//   Key blocks with the most query rows (the first, causal) launch first.
// - bwd_dq_wgmma: one block per (b, h, 128 query rows), 64 rows a
//   consumer warpgroup, q and do loaded once, 64-key k and v tiles in a
//   two-stage ring.  Per tile, S = Q K^T and dP = dO V^T, dS in
//   registers, dQ += dS K (register-A against the MN-major k tile, the
//   forward's O += P V).  Query tiles with the most keys launch first.

constexpr int kWsThreads = 384;    // producer + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kKeys = 128;         // keys a dk/dv block
constexpr int kQRows = 128;        // query rows a dq block
constexpr int kTile = 64;          // rows a ring tile, a TMA box, a warpgroup
constexpr int kStages = 2;
constexpr uint32_t kBoxBytes = kTile * 128;   // 64 rows x 128 bytes

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the forward's logit in log2 units (flash_attention.cu's logit2, the
// softcap as cap * (1 - 2 / (exp2(2 log2(e) x / cap) + 1))) and, with the
// softcap, ds/dx
template <bool CAP>
__device__ __forceinline__ float logit2(const Params& p, float acc,
                                        float& dcap) {
  if (CAP) {
    const float th = 1.f - 2.f * rcp(ex2(acc * p.cap_in) + 1.f);
    dcap = 1.f - th * th;
    return p.cap_out * th;
  }
  return acc * p.qk2;
}

// whether some pair of queries [qa, qb] x keys [ka, kb] is visible (true
// may still mean none is: the per-element mask then runs)
__device__ __forceinline__ bool pairs_any(const Params& p, int qa, int qb,
                                          int ka, int kb) {
  if (qa >= p.Sq || ka >= p.Sk) return false;
  if (p.causal && ka > qb) return false;
  if (p.has_window && !((long long)qa - kb < (long long)p.window)) {
    return false;
  }
  return true;
}

// whether some pair of queries [qa, qb] x keys [ka, kb] is masked
__device__ __forceinline__ bool pairs_cut(const Params& p, int qa, int qb,
                                          int ka, int kb) {
  if (qb >= p.Sq || kb >= p.Sk) return true;
  if (p.causal && kb > qa) return true;
  if (p.has_window && !((long long)qb - ka < (long long)p.window)) {
    return true;
  }
  return false;
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of an m64n64
// accumulator, rounded to bf16: the C layout of two neighbouring n8
// blocks is the register-A layout
__device__ __forceinline__ void a_fragment(const float (&s)[32], int kk,
                                           uint32_t (&a)[4]) {
  const int i = 8 * kk;
  a[0] = pack_f(s[i], s[i + 1]);
  a[1] = pack_f(s[i + 2], s[i + 3]);
  a[2] = pack_f(s[i + 4], s[i + 5]);
  a[3] = pack_f(s[i + 6], s[i + 7]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 64-bit shared-memory matrix descriptor of a 128-byte-swizzled operand
// (flash_attention.cu's): K-major, SBO = 1024 (8 rows of 128 B), LBO
// unused; MN-major, LBO = the distance between 64-column atom columns,
// SBO = 1024 (8 rows of k)
__device__ __forceinline__ uint64_t smem_desc(const void* ptr, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_u32(ptr);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads and writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// one 64 x 64 box of a 4-D tensor map (coordinates innermost first) into
// shared memory, completing its bytes on the barrier
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// rows [r0, r0 + R) of head h into a swizzled tile of R rows (R / 64 boxes
// an atom column)
template <int D, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int r0,
                                         int h, int b, uint64_t* bar) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a) {
#pragma unroll
    for (int r = 0; r < R / kTile; ++r) {
      tma_load_4d(dst + a * R * 128 + r * kBoxBytes, map, a * 64,
                  r0 + r * kTile, h, b, bar);
    }
  }
}

// d[32] += A (smem, K-major) . B (smem, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[32] += A (registers) . B (smem, MN-major: transposed), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (registers) . B (smem, MN-major: transposed), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

// Issue S (or S^T) and dP (or dP^T) of one 64 x 64 tile as one wgmma
// group: A rows from `a0` and `a1`, B rows from `b0` and `b1`, all K-major
// over D; the atom columns of the A tiles lie `as` bytes apart, of the B
// tiles `bs`.  wait_products() waits for them.
template <int D>
__device__ __forceinline__ void issue_products(float (&s)[32], float (&dp)[32],
                                             const unsigned char* a0,
                                             const unsigned char* b0,
                                             const unsigned char* a1,
                                             const unsigned char* b1,
                                             uint32_t as, uint32_t bs) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    // k-step kc: atom column kc / 4, 32 bytes in per step inside it
    const int a = kc >> 2, kb = (kc & 3) * 32;
    wgmma_ss_n64(s, smem_desc(a0 + a * as + kb, 16, 1024),
                 smem_desc(b0 + a * bs + kb, 16, 1024));
  }
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int a = kc >> 2, kb = (kc & 3) * 32;
    wgmma_ss_n64(dp, smem_desc(a1 + a * as + kb, 16, 1024),
                 smem_desc(b1 + a * bs + kb, 16, 1024));
  }
  wgmma_commit();
}

__device__ __forceinline__ void wait_products(float (&s)[32],
                                              float (&dp)[32]) {
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

// Ping-pong: named barriers 1 and 2 (0 is __syncthreads') let consumer
// warpgroup c issue its shared-memory products only after the other one
// has issued its own, so that one's element-wise work overlaps the
// other's products instead of both waiting on the tensor cores in step.
// Each barrier completes on 256 threads: the 128 that sync and the 128 of
// the other warpgroup that arrive.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(kConsumers)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(kConsumers)
               : "memory");
}

// dk/dv's P^T and dS^T in place of S^T and dP^T (element i: key key0 +
// 8 ((i >> 1) & 1), query i0 + col), the queries' lse2 and delta from
// shared memory `rs`: P = 2^(s - lse2), dS = P (dP - delta) ds/dx, both 0
// where masked (CUT: the tile holds a masked pair).  Straight-line code:
// a branch per element would keep the compiler from interleaving them.
template <bool CAP, bool CUT>
__device__ __forceinline__ void grads_t(const Params& p, float (&st)[32],
                                        float (&dpt)[32], const float* rs,
                                        int i0, int key0, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    float dcap = 1.f;
    const float x = logit2<CAP>(p, st[i], dcap);
    float P = ex2(x - rs[col]);
    float dS = P * (dpt[i] - rs[kTile + col]);
    if (CAP) dS *= dcap;
    if (CUT && !visible(p, i0 + col, key0 + 8 * ((i >> 1) & 1))) {
      P = 0.f;
      dS = 0.f;
    }
    st[i] = P;
    dpt[i] = dS;
  }
}

// dq's dS in place of S (element i: row rows[(i >> 1) & 1], key k0 + col)
// from the rows' lse2 and delta in registers, as grads_t
template <bool CAP, bool CUT>
__device__ __forceinline__ void grads(const Params& p, float (&sc)[32],
                                      const float (&dp)[32],
                                      const float (&lse)[2],
                                      const float (&dl)[2],
                                      const int (&rows)[2], int k0, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    float dcap = 1.f;
    const float x = logit2<CAP>(p, sc[i], dcap);
    float dS = ex2(x - lse[r]) * (dp[i] - dl[r]);
    if (CAP) dS *= dcap;
    if (CUT && !visible(p, rows[r], k0 + col)) dS = 0.f;
    sc[i] = dS;
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  // slack to align the swizzled tiles; k and v (128 rows); the ring's q
  // and do tiles (64 rows) and its rows' lse2 and delta; the barriers
  return 1024 + 2 * (size_t)kKeys * D * 2 +
         kStages * (2 * (size_t)kTile * D * 2 + 2 * kTile * 4) +
         8 * (2 * kStages + 1);
}

template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  // slack; q and do (128 rows); the ring's k and v tiles (64 rows); the
  // barriers
  return 1024 + 2 * (size_t)kQRows * D * 2 +
         kStages * 2 * (size_t)kTile * D * 2 + 8 * (2 * kStages + 1);
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int NA = D / 64;
  constexpr uint32_t KA = kKeys * 128;     // bytes of a k or v atom column
  constexpr uint32_t QA = kTile * 128;     // ... of a q or do atom column
  constexpr uint32_t KT = NA * KA, QT = NA * QA;
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + KT;
  unsigned char* ring = Vs + KT;           // stage s: q, then do
  float* rows = reinterpret_cast<float*>(ring + kStages * 2 * QT);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int G = p.H / p.Hkv, gs = G / p.groups;
  const int hk = blockIdx.x / p.groups, grp = blockIdx.x % p.groups;
  const int b = blockIdx.y, j0 = blockIdx.z * kKeys;
  const int h0 = hk * G + grp * gs;
  int lo, hi;
  query_range(p, j0, min(j0 + kKeys, p.Sk), lo, hi);
  const int nt = (hi - lo + kTile - 1) / kTile;   // query tiles a head
  const int n = gs * nt;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);             // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<40>();
    if (tid >= 32) return;
    // the producer warp: lane 0 issues the TMA loads, every lane brings
    // two rows' lse2 and delta, and each lane's arrival releases its own
    const int lane = tid;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * KT);
      tma_tile<D, kKeys>(Ks, &tk, j0, hk, b, kvbar);
      tma_tile<D, kKeys>(Vs, &tv, j0, hk, b, kvbar);
    }
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const int h = h0 + it / nt, i0 = lo + (it % nt) * kTile;
      // the rows' lse2 and delta, read before the stage is free
      float lr[kTile / 32], dr[kTile / 32];
#pragma unroll
      for (int r = 0; r < kTile / 32; ++r) {
        const int i = i0 + lane + 32 * r;
        const long long at = ((long long)b * p.H + h) * p.Sq + i;
        lr[r] = i < p.Sq ? p.lse[at] : 0.f;
        dr[r] = i < p.Sq ? p.delta[at] : 0.f;
      }
      if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
      float* rs = rows + s * 2 * kTile;
#pragma unroll
      for (int r = 0; r < kTile / 32; ++r) {
        rs[lane + 32 * r] = lr[r];
        rs[kTile + lane + 32 * r] = dr[r];
      }
      if (lane == 0) {
        unsigned char* qs = ring + s * 2 * QT;
        mbar_expect_tx(&full[s], 2 * QT);
        tma_tile<D, kTile>(qs, &tq, i0, h, b, &full[s]);
        tma_tile<D, kTile>(qs + QT, &tdo, i0, h, b, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    regs_inc<232>();
    const int c = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw_lo = j0 + c * kTile, kw_hi = kw_lo + kTile - 1;
    const unsigned char* Kw = Ks + c * kBoxBytes;   // this warpgroup's keys
    const unsigned char* Vw = Vs + c * kBoxBytes;
    const int key0 = kw_lo + warp * 16 + g;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kvbar, 0);
    if (c == 1) turn_pass(c);   // warpgroup 0 issues first
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const int i0 = lo + (it % nt) * kTile;
      turn_wait(c);
      // warpgroup-uniform: skip a tile none of this warpgroup's keys sees
      if (!pairs_any(p, i0, i0 + kTile - 1, kw_lo, kw_hi)) {
        turn_pass(c);
      } else {
        const unsigned char* qs = ring + s * 2 * QT;
        const unsigned char* dos = qs + QT;
        const float* rs = rows + s * 2 * kTile;
        // S^T = K Q^T, dP^T = V dO^T: the warpgroup's 64 keys x 64 queries
        float st[32], dpt[32];
        issue_products<D>(st, dpt, Kw, qs, Vw, dos, KA, QA);
        turn_pass(c);
        wait_products(st, dpt);
        // element i: key key0 + 8 ((i >> 1) & 1), query i0 + col
        // the softcap and the mask are uniform: straight-line code each
        if (pairs_cut(p, i0, i0 + kTile - 1, kw_lo, kw_hi)) {
          if (p.cap > 0.f) {
            grads_t<true, true>(p, st, dpt, rs, i0, key0, t);
          } else {
            grads_t<false, true>(p, st, dpt, rs, i0, key0, t);
          }
        } else if (p.cap > 0.f) {
          grads_t<true, false>(p, st, dpt, rs, i0, key0, t);
        } else {
          grads_t<false, false>(p, st, dpt, rs, i0, key0, t);
        }
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          a_fragment(st, kk, pa[kk]);
          a_fragment(dpt, kk, da[kk]);
        }
        // dV += P^T dO, dK += dS^T Q: queries 16 kk .. 16 kk + 15 of the
        // MN-major do and q tiles
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<D>(dv, pa[kk], smem_desc(dos + kk * 16 * 128, QA, 1024));
          wgmma_rs<D>(dk, da[kk], smem_desc(qs + kk * 16 * 128, QA, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(&empty[s]);   // stage s may take tile it + kStages
    }
    if (c == 0) turn_wait(c);   // warpgroup 1's last pass

    // element 4 nd + 2 r + e: key key0 + 8 r, column 8 nd + 2 t + e
    if (p.groups == 1) {
      bf16* dkp = static_cast<bf16*>(p.dk);
      bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= p.Sk) continue;
        const long long base =
            (((long long)b * p.Sk + key) * p.Hkv + hk) * D + 2 * t;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          *reinterpret_cast<uint32_t*>(dkp + base + 8 * nd) =
              pack_f(dk[4 * nd + 2 * r] * p.scale,
                     dk[4 * nd + 2 * r + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvp + base + 8 * nd) =
              pack_f(dv[4 * nd + 2 * r], dv[4 * nd + 2 * r + 1]);
        }
      }
    } else {
      const long long plane = (long long)p.groups * p.B * p.Sk * p.Hkv * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= p.Sk) continue;
        float* dst = p.part +
                     ((((long long)grp * p.B + b) * p.Sk + key) * p.Hkv +
                      hk) * D + 2 * t;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          *reinterpret_cast<float2*>(dst + 8 * nd) =
              make_float2(dk[4 * nd + 2 * r], dk[4 * nd + 2 * r + 1]);
          *reinterpret_cast<float2*>(dst + plane + 8 * nd) =
              make_float2(dv[4 * nd + 2 * r], dv[4 * nd + 2 * r + 1]);
        }
      }
    }
  }
}

// dk = scale * the sum of the groups' shares, dv = their sum, the groups
// in order (no atomics); four elements a thread
__global__ void __launch_bounds__(kThreads)
    bwd_reduce(const __grid_constant__ Params p) {
  const long long n = (long long)p.B * p.Sk * p.Hkv * p.D;
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  const long long plane = (long long)p.groups * n;
  float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = k4;
  for (int gi = 0; gi < p.groups; ++gi) {
    const float4 a = *reinterpret_cast<const float4*>(p.part + gi * n + e);
    const float4 c =
        *reinterpret_cast<const float4*>(p.part + plane + gi * n + e);
    k4.x += a.x; k4.y += a.y; k4.z += a.z; k4.w += a.w;
    v4.x += c.x; v4.y += c.y; v4.z += c.z; v4.w += c.w;
  }
  *reinterpret_cast<uint2*>(static_cast<bf16*>(p.dk) + e) =
      make_uint2(pack_f(k4.x * p.scale, k4.y * p.scale),
                 pack_f(k4.z * p.scale, k4.w * p.scale));
  *reinterpret_cast<uint2*>(static_cast<bf16*>(p.dv) + e) =
      make_uint2(pack_f(v4.x, v4.y), pack_f(v4.z, v4.w));
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int NA = D / 64;
  constexpr uint32_t QA = kQRows * 128;    // bytes of a q or do atom column
  constexpr uint32_t TA = kTile * 128;     // ... of a k or v atom column
  constexpr uint32_t QT = NA * QA, TT = NA * TA;
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Os = Qs + QT;             // do
  unsigned char* ring = Os + QT;           // stage s: k, then v
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * TT);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kQRows;  // longest first
  const int hk = h / (p.H / p.Hkv);
  int lo, hi;
  key_range(p, q0, min(q0 + kQRows, p.Sq), lo, hi);
  const int n = (hi - lo + kTile - 1) / kTile;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<40>();
    if (tid != 0) return;
    mbar_expect_tx(qbar, 2 * QT);
    tma_tile<D, kQRows>(Qs, &tq, q0, h, b, qbar);
    tma_tile<D, kQRows>(Os, &tdo, q0, h, b, qbar);
    for (int j = 0; j < n; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
      unsigned char* ks = ring + s * 2 * TT;
      mbar_expect_tx(&full[s], 2 * TT);
      tma_tile<D, kTile>(ks, &tk, lo + j * kTile, hk, b, &full[s]);
      tma_tile<D, kTile>(ks + TT, &tv, lo + j * kTile, hk, b, &full[s]);
    }
  } else {
    regs_inc<232>();
    const int c = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wq_lo = q0 + c * kTile, wq_hi = wq_lo + kTile - 1;
    const int rows[2] = {wq_lo + warp * 16 + g, wq_lo + warp * 16 + g + 8};
    float lse[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = ((long long)b * p.H + h) * p.Sq + rows[r];
      lse[r] = rows[r] < p.Sq ? p.lse[at] : 0.f;
      dl[r] = rows[r] < p.Sq ? p.delta[at] : 0.f;
    }
    const unsigned char* Qw = Qs + c * kBoxBytes;   // this warpgroup's rows
    const unsigned char* Ow = Os + c * kBoxBytes;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(qbar, 0);
    if (c == 1) turn_pass(c);   // warpgroup 0 issues first
    for (int j = 0; j < n; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const int k0 = lo + j * kTile;
      turn_wait(c);
      if (!pairs_any(p, wq_lo, wq_hi, k0, k0 + kTile - 1)) {
        turn_pass(c);
      } else {
        const unsigned char* ks = ring + s * 2 * TT;
        const unsigned char* vs = ks + TT;
        // S = Q K^T, dP = dO V^T: the warpgroup's 64 rows x 64 keys
        float sc[32], dp[32];
        issue_products<D>(sc, dp, Qw, ks, Ow, vs, QA, TA);
        turn_pass(c);
        wait_products(sc, dp);
        // element i: row rows[(i >> 1) & 1], key k0 + col
        if (pairs_cut(p, wq_lo, wq_hi, k0, k0 + kTile - 1)) {
          if (p.cap > 0.f) {
            grads<true, true>(p, sc, dp, lse, dl, rows, k0, t);
          } else {
            grads<false, true>(p, sc, dp, lse, dl, rows, k0, t);
          }
        } else if (p.cap > 0.f) {
          grads<true, false>(p, sc, dp, lse, dl, rows, k0, t);
        } else {
          grads<false, false>(p, sc, dp, lse, dl, rows, k0, t);
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_fragment(sc, kk, da[kk]);
        // dQ += dS K: keys 16 kk .. 16 kk + 15 of the MN-major k tile
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<D>(dq, da[kk], smem_desc(ks + kk * 16 * 128, TA, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
      }
      mbar_arrive(&empty[s]);   // stage s may take tile j + kStages
    }
    if (c == 0) turn_wait(c);   // warpgroup 1's last pass

    bf16* dqp = static_cast<bf16*>(p.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.Sq) continue;
      bf16* dst = dqp + (((long long)b * p.Sq + rows[r]) * p.H + h) * D +
                  2 * t;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_f(dq[4 * nd + 2 * r] * p.scale,
                   dq[4 * nd + 2 * r + 1] * p.scale);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, without linking -lcuda
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// a 4-D map over a dense (B, S, heads, D) bf16 tensor, innermost first;
// boxes of 64 columns x 64 rows, 128-byte swizzle, zeros outside
bool tensor_map(CUtensorMap* map, const void* base, int D, int S, int heads,
                int B) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(S > 0 ? S : 1),
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)heads * D * 2,
                                 (cuuint64_t)D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)kTile, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t st) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkdv_smem<D>());
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dq_smem<D>());
  }();
  if (attr != cudaSuccess) return attr;
  const long long nkb = (p.Sk + kKeys - 1) / kKeys;
  const long long nqt = (p.Sq + kQRows - 1) / kQRows;
  if (nkb > 65535 || nqt > 65535 ||
      (long long)p.Hkv * p.groups > 0x7fffffffLL) {
    return cudaErrorInvalidConfiguration;
  }
  // the shapes' strides: the wrapper makes the operands dense
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, p.q, D, p.Sq, p.H, p.B) ||
      !tensor_map(&tk, p.k, D, p.Sk, p.Hkv, p.B) ||
      !tensor_map(&tv, p.v, D, p.Sk, p.Hkv, p.B) ||
      !tensor_map(&tdo, p.dout, D, p.Sq, p.H, p.B)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = launch_delta<bf16>(p, st);
  if (e != cudaSuccess) return e;
  if (p.Sk > 0) {
    bwd_dkdv_wgmma<D><<<dim3(p.Hkv * p.groups, p.B, (unsigned)nkb),
                        kWsThreads, dkdv_smem<D>(), st>>>(tq, tk, tv, tdo, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (p.groups > 1) {
      const long long quads = (long long)p.B * p.Sk * p.Hkv * D / 4;
      bwd_reduce<<<(unsigned)((quads + kThreads - 1) / kThreads), kThreads,
                   0, st>>>(p);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  bwd_dq_wgmma<D><<<dim3(p.H, p.B, (unsigned)nqt), kWsThreads, dq_smem<D>(),
                    st>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

}  // namespace

// path: 0 the CUDA cores, 1 wgmma (bf16, D 64 or 128), as
// kernels/flash_attention.py's bwd_path chooses.  dtype: 0 float32, 1
// bfloat16.  Every operand dense (B, S, heads, D) and 16-byte aligned; lse
// the forward's f32 (B, H, Sq) logsumexp (log2 units), delta an f32
// (B, H, Sq) scratch.  groups: on the wgmma path, how many groups of G / groups
// query heads a kv head's dk / dv blocks take; part an f32 (2, groups, B,
// Sk, Hkv, D) scratch when groups > 1.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* part, int B, int Sq, int Sk, int H, int Hkv, int D,
    int causal, int has_window, int window, float scale, float cap,
    int dtype, int path, int groups, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      D < 8 || D > 256 || D % 8 != 0 || (dtype != 0 && dtype != 1) ||
      lse == nullptr || delta == nullptr) {
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
  p.lse = static_cast<const float*>(lse);
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
  p.groups = groups;
  p.scale = scale;
  p.cap = cap;
  p.qk2 = scale * kLog2e;
  p.cap_in = cap > 0.f ? 2.f * kLog2e * scale / cap : 0.f;
  p.cap_out = cap * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const int G = H / Hkv;
    if (dtype != 1 || groups < 1 || G % groups != 0 ||
        (groups > 1 && Sk > 0 && part == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    if (D == 64) return (int)launch_wgmma<64>(p, s);
    if (D == 128) return (int)launch_wgmma<128>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? (int)launch_cores_d<bf16>(p, s)
                    : (int)launch_cores_d<float>(p, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
