// ssd_scan — Mamba2's SSD chunked scan (arXiv:2405.21060 §6) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py
// (ssd_scan_kernel, body _kernel).  Per chunk of Q steps, with
// da = dt*A <= 0 and da_cs its running sum inside the chunk:
//
//   y_i   = sum_{j<=i} (C_i.B_j) exp(da_cs_i - da_cs_j) dt_j x_j   (intra)
//         + exp(da_cs_i) C_i . state                               (inter)
//   state <- state exp(da_tot) + sum_q exp(da_tot - da_cs_q) dt_q B_q (x) x_q
//
// starting from init_state (or zeros).  x, B, C are f32 or bf16; dt, A
// and the state are f32; all arithmetic is f32; y is written in x's type.
// Head h reads group h / (H / G), for any G that divides H.
//
// Bound: operations.  At the mamba2-1.3b serving shape (B 4, S 1024,
// H 64, P 64, N 128, Q 256) the lower-triangular intra-chunk products,
// the inter-chunk product and the state update are 13-17 GFLOP against
// about 0.15 GB of inputs and outputs.  The TPU kernel walks the chunks
// of one (batch, head block) in order on one core, carrying the state in
// VMEM.  Here the chunks run in parallel instead, in three passes on the
// caller's stream:
//
//   1. chunk_state (grid chunks x heads x batch): da_cs of the chunk by a
//      fixed-order scan (written out for pass 3), and the chunk's own
//      state increment sum_q w_q x_q (x) B_q, a (P x Q)(Q x N) product
//      over Q tiles staged in shared memory.
//   2. state_pass (grid P*N/256 x heads x batch): the only sequential
//      part, elementwise over the (P, N) state: it replaces each chunk's
//      increment by the state entering that chunk and writes the final
//      state.
//   3. chunk_out (grid batch*heads x chunks x Q/64): 64 rows of one chunk
//      per block.  The inter-chunk term is a (64 x N)(N x P) product with
//      the entering state; the intra-chunk term walks the 32-step source
//      tiles j <= i, forming the 64 x 32 score tile C.B^T in shared memory
//      and masking it before exp (a positive segment sum is never
//      exponentiated; the upper triangle contributes exactly 0).  The
//      whole Q x Q matrix never exists, in shared or device memory.
//
// Every sum runs in a fixed order and nothing is accumulated with
// atomics, so results are the same bits from run to run, and a null
// init_state reads as zeros through the same arithmetic as explicit
// zeros (bitwise equal).  Steps past S (a ragged last chunk) read as
// dt = 0, x = B = C = 0 and are never written.  The products run on the
// CUDA cores with register tiles (4 x 8 outputs a thread in pass 1,
// 4 x 4 and 2 x 4 in pass 3); wgmma/TMA are not used yet.  Shape
// envelope: P <= 64, N <= 128, Q <= 1024 (the wrapper raises outside it).
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); launches on the caller's stream and
// returns the first launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 64;          // register tiles cover P <= 64
constexpr int kMaxN = 128;         // and N <= 128
constexpr int kMaxQ = 1024;        // the scan gives each lane <= 32 steps
constexpr int kLdP = kMaxP + 1;    // padded shared-memory row strides:
constexpr int kLdN = kMaxN + 1;    // consecutive rows one bank apart
constexpr int kQT = 32;            // steps per tile in chunk_state
constexpr int kRows = 64;          // chunk rows per block in chunk_out
constexpr int kJ = 32;             // source steps per tile in chunk_out
constexpr int kLdJ = kJ + 1;
// chunk_out's shared memory that holds the state first, then the tiles
constexpr int kTiles = kJ * kLdN + kJ * kLdP + kRows * kLdJ;
constexpr int kUnion = kMaxP * kLdN > kTiles ? kMaxP * kLdN : kTiles;

struct Dims {
  int B, S, H, P, G, N, Q, nc, rep;
  long long x_sb, x_ss;    // element strides over batch and step
  long long dt_sb, dt_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // round to nearest even, as torch's .to()
}

// Inclusive running sum of v[0..n) in place, in a fixed order: each lane
// of warp 0 sums a contiguous run of steps, lane 0 adds the run totals in
// order, and each run adds its offset.  The last value of a run equals
// the next run's offset exactly, so a sum of values <= 0 stays
// non-increasing across runs.  Call with all threads; ends synchronized.
__device__ void running_sum(float* v, int n, float* totals) {
  const int lane = threadIdx.x;
  const int len = (n + 31) / 32;
  const int lo = min(lane * len, n);
  const int hi = min(lo + len, n);
  if (threadIdx.x < 32) {
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += v[i];
      v[i] = run;
    }
    totals[lane] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int k = 0; k < 32; ++k) {
      const float t = totals[k];
      totals[k] = acc;              // exclusive offset of run k
      acc += t;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32 && lane > 0) {
    const float off = totals[lane];
    for (int i = lo; i < hi; ++i) v[i] = off + v[i];
  }
  __syncthreads();
}

// Pass 1: per (chunk, head, batch), da_cs -> dacs_out and the chunk's
// state increment sum_q w_q x_q (x) B_q -> upd_out (P x N, f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            float* __restrict__ dacs_out, float* __restrict__ upd_out,
            Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* s_da = smem;                  // Q: dt*A, then its running sum
  float* s_w = s_da + d.Q;             // Q: dt, then the input weights
  float* s_x = s_w + d.Q;              // kQT x kLdP: w * x
  float* s_b = s_x + kQT * kLdP;       // kQT x kLdN
  float* s_tot = s_b + kQT * kLdN;     // 32: run totals of the scan
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / d.rep;
  const int tid = threadIdx.x;
  const long long s0 = (long long)c * d.Q;
  const float a = A[h];

  for (int q = tid; q < d.Q; q += kThreads) {
    const long long s = s0 + q;
    const float t = s < d.S ? dt[b * d.dt_sb + s * d.dt_ss + h] : 0.f;
    s_w[q] = t;
    s_da[q] = t * a;
  }
  __syncthreads();
  running_sum(s_da, d.Q, s_tot);
  const float tot = s_da[d.Q - 1];
  float* dacs = dacs_out + ((long long)(b * d.H + h) * d.nc + c) * d.Q;
  for (int q = tid; q < d.Q; q += kThreads) {
    dacs[q] = s_da[q];
    s_w[q] = expf(tot - s_da[q]) * s_w[q];
  }

  const int tp = tid / 16, tn = tid % 16;   // rows tp + 16i, cols tn + 16j
  float acc[kMaxP / 16][kMaxN / 16];
#pragma unroll
  for (int i = 0; i < kMaxP / 16; ++i)
#pragma unroll
    for (int j = 0; j < kMaxN / 16; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < d.Q; q0 += kQT) {
    __syncthreads();              // s_w written / previous tile consumed
    for (int e = tid; e < kQT * kMaxP; e += kThreads) {
      const int qq = e / kMaxP, p = e % kMaxP;
      const int q = q0 + qq;
      const long long s = s0 + q;
      float v = 0.f;
      if (q < d.Q && s < d.S && p < d.P)
        v = load(x + b * d.x_sb + s * d.x_ss + (long long)h * d.P + p) *
            s_w[q];
      s_x[qq * kLdP + p] = v;
    }
    for (int e = tid; e < kQT * kMaxN; e += kThreads) {
      const int qq = e / kMaxN, n = e % kMaxN;
      const int q = q0 + qq;
      const long long s = s0 + q;
      float v = 0.f;
      if (q < d.Q && s < d.S && n < d.N)
        v = load(Bm + b * d.b_sb + s * d.b_ss + (long long)g * d.N + n);
      s_b[qq * kLdN + n] = v;
    }
    __syncthreads();
    const int nq = min(kQT, d.Q - q0);
    for (int qq = 0; qq < nq; ++qq) {
      float xv[kMaxP / 16], bv[kMaxN / 16];
#pragma unroll
      for (int i = 0; i < kMaxP / 16; ++i) xv[i] = s_x[qq * kLdP + tp + 16 * i];
#pragma unroll
      for (int j = 0; j < kMaxN / 16; ++j) bv[j] = s_b[qq * kLdN + tn + 16 * j];
#pragma unroll
      for (int i = 0; i < kMaxP / 16; ++i)
#pragma unroll
        for (int j = 0; j < kMaxN / 16; ++j)
          acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }

  float* upd = upd_out + ((long long)(b * d.H + h) * d.nc + c) * d.P * d.N;
#pragma unroll
  for (int i = 0; i < kMaxP / 16; ++i) {
    const int p = tp + 16 * i;
#pragma unroll
    for (int j = 0; j < kMaxN / 16; ++j) {
      const int n = tn + 16 * j;
      if (p < d.P && n < d.N) upd[p * d.N + n] = acc[i][j];
    }
  }
}

// Pass 2: per state element, walk the chunks in order; each chunk's
// increment is replaced by the state entering the chunk.
__global__ void __launch_bounds__(kThreads)
state_pass(const float* __restrict__ init, const float* __restrict__ dacs,
           float* __restrict__ states, float* __restrict__ final_state,
           Dims d) {
  const int pn = d.P * d.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const long long bh = (long long)blockIdx.z * d.H + blockIdx.y;
  if (e >= pn) return;
  float s = init != nullptr ? init[bh * pn + e] : 0.f;
  for (int c = 0; c < d.nc; ++c) {
    float* st = states + (bh * d.nc + c) * pn + e;
    const float u = *st;
    *st = s;
    const float decay = expf(dacs[(bh * d.nc + c) * d.Q + d.Q - 1]);
    s = s * decay + u;
  }
  final_state[bh * pn + e] = s;
}

// Pass 3: 64 rows of one chunk: the inter-chunk term from the entering
// state, then the intra-chunk term over the source tiles j <= i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_out(const T* __restrict__ x, const float* __restrict__ dt,
          const T* __restrict__ Bm, const T* __restrict__ Cm,
          const float* __restrict__ dacs_in, const float* __restrict__ states,
          T* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* s_c = smem;                   // kRows x kLdN: this block's C rows
  float* s_st = s_c + kRows * kLdN;    // kMaxP x kLdN: the entering state,
  float* s_b = s_st;                   // then kJ x kLdN source B rows,
  float* s_x = s_b + kJ * kLdN;        // kJ x kLdP source x rows,
  float* s_l = s_x + kJ * kLdP;        // kRows x kLdJ masked scores
  float* s_da = s_st + kUnion;         // Q: da_cs of the chunk
  float* s_dt = s_da + d.Q;            // kJ: dt of the source tile

  const int bh = blockIdx.x, c = blockIdx.y, i0 = blockIdx.z * kRows;
  const int b = bh / d.H, h = bh % d.H, g = h / d.rep;
  const int tid = threadIdx.x;
  const long long s0 = (long long)c * d.Q;
  const int i_end = min(i0 + kRows, d.Q);    // rows of the block: [i0, i_end)
  const float* dacs = dacs_in + ((long long)bh * d.nc + c) * d.Q;
  const float* st = states + ((long long)bh * d.nc + c) * d.P * d.N;

  for (int q = tid; q < i_end; q += kThreads) s_da[q] = dacs[q];
  for (int e = tid; e < kRows * kMaxN; e += kThreads) {
    const int r = e / kMaxN, n = e % kMaxN;
    const int i = i0 + r;
    const long long s = s0 + i;
    float v = 0.f;
    if (i < i_end && s < d.S && n < d.N)
      v = load(Cm + b * d.c_sb + s * d.c_ss + (long long)g * d.N + n);
    s_c[r * kLdN + n] = v;
  }
  for (int e = tid; e < kMaxP * kMaxN; e += kThreads) {
    const int p = e / kMaxN, n = e % kMaxN;
    s_st[p * kLdN + n] = (p < d.P && n < d.N) ? st[p * d.N + n] : 0.f;
  }
  __syncthreads();

  // inter-chunk: acc[i][p] = exp(da_cs_i) * sum_n C[i][n] state[p][n]
  const int tr = tid / 16, tp = tid % 16;    // rows tr + 16a, cols tp + 16k
  float acc[kRows / 16][kMaxP / 16];
#pragma unroll
  for (int a = 0; a < kRows / 16; ++a)
#pragma unroll
    for (int k = 0; k < kMaxP / 16; ++k) acc[a][k] = 0.f;
  for (int n = 0; n < d.N; ++n) {
    float cv[kRows / 16], sv[kMaxP / 16];
#pragma unroll
    for (int a = 0; a < kRows / 16; ++a) cv[a] = s_c[(tr + 16 * a) * kLdN + n];
#pragma unroll
    for (int k = 0; k < kMaxP / 16; ++k) sv[k] = s_st[(tp + 16 * k) * kLdN + n];
#pragma unroll
    for (int a = 0; a < kRows / 16; ++a)
#pragma unroll
      for (int k = 0; k < kMaxP / 16; ++k)
        acc[a][k] = fmaf(cv[a], sv[k], acc[a][k]);
  }
#pragma unroll
  for (int a = 0; a < kRows / 16; ++a) {
    const int i = i0 + tr + 16 * a;
    const float decay = i < i_end ? expf(s_da[i]) : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxP / 16; ++k) acc[a][k] *= decay;
  }

  // intra-chunk, one source tile of kJ steps at a time
  const int ti = tid / 8, tj = tid % 8;      // scores: rows ti + 32u, cols tj + 8m
  for (int j0 = 0; j0 < i_end; j0 += kJ) {
    __syncthreads();                  // the state / previous tile consumed
    for (int e = tid; e < kJ * kMaxN; e += kThreads) {
      const int jj = e / kMaxN, n = e % kMaxN;
      const int j = j0 + jj;
      const long long s = s0 + j;
      float v = 0.f;
      if (j < i_end && s < d.S && n < d.N)
        v = load(Bm + b * d.b_sb + s * d.b_ss + (long long)g * d.N + n);
      s_b[jj * kLdN + n] = v;
    }
    for (int e = tid; e < kJ * kMaxP; e += kThreads) {
      const int jj = e / kMaxP, p = e % kMaxP;
      const int j = j0 + jj;
      const long long s = s0 + j;
      float v = 0.f;
      if (j < i_end && s < d.S && p < d.P)
        v = load(x + b * d.x_sb + s * d.x_ss + (long long)h * d.P + p);
      s_x[jj * kLdP + p] = v;
    }
    if (tid < kJ) {
      const int j = j0 + tid;
      const long long s = s0 + j;
      s_dt[tid] = (j < i_end && s < d.S) ? dt[b * d.dt_sb + s * d.dt_ss + h]
                                          : 0.f;
    }
    __syncthreads();

    float sc[kRows / 32][kJ / 8];
#pragma unroll
    for (int u = 0; u < kRows / 32; ++u)
#pragma unroll
      for (int m = 0; m < kJ / 8; ++m) sc[u][m] = 0.f;
    for (int n = 0; n < d.N; ++n) {
      float cv[kRows / 32], bv[kJ / 8];
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) cv[u] = s_c[(ti + 32 * u) * kLdN + n];
#pragma unroll
      for (int m = 0; m < kJ / 8; ++m) bv[m] = s_b[(tj + 8 * m) * kLdN + n];
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u)
#pragma unroll
        for (int m = 0; m < kJ / 8; ++m)
          sc[u][m] = fmaf(cv[u], bv[m], sc[u][m]);
    }
#pragma unroll
    for (int u = 0; u < kRows / 32; ++u) {
      const int r = ti + 32 * u;
      const int i = i0 + r;
#pragma unroll
      for (int m = 0; m < kJ / 8; ++m) {
        const int jj = tj + 8 * m;
        const int j = j0 + jj;
        float v = 0.f;
        if (i < i_end && j <= i)     // mask before exp: the segment is <= 0
          v = sc[u][m] * expf(s_da[i] - s_da[j]) * s_dt[jj];
        s_l[r * kLdJ + jj] = v;
      }
    }
    __syncthreads();

    for (int jj = 0; jj < kJ; ++jj) {
      float lv[kRows / 16], xv[kMaxP / 16];
#pragma unroll
      for (int a = 0; a < kRows / 16; ++a) lv[a] = s_l[(tr + 16 * a) * kLdJ + jj];
#pragma unroll
      for (int k = 0; k < kMaxP / 16; ++k) xv[k] = s_x[jj * kLdP + tp + 16 * k];
#pragma unroll
      for (int a = 0; a < kRows / 16; ++a)
#pragma unroll
        for (int k = 0; k < kMaxP / 16; ++k)
          acc[a][k] = fmaf(lv[a], xv[k], acc[a][k]);
    }
  }

#pragma unroll
  for (int a = 0; a < kRows / 16; ++a) {
    const int i = i0 + tr + 16 * a;
    const long long s = s0 + i;
    if (i >= i_end || s >= d.S) continue;
#pragma unroll
    for (int k = 0; k < kMaxP / 16; ++k) {
      const int p = tp + 16 * k;
      if (p < d.P)
        store(y + ((long long)b * d.S + s) * d.H * d.P + (long long)h * d.P + p,
              acc[a][k]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init, void* y,
                   float* final_state, float* dacs, float* states,
                   const Dims& d, cudaStream_t stream) {
  auto smem1_for = [](int q) {
    return sizeof(float) * (2 * q + kQT * kLdP + kQT * kLdN + 32);
  };
  auto smem3_for = [](int q) {
    return sizeof(float) * (kRows * kLdN + kUnion + q + kJ);
  };
  const size_t smem1 = smem1_for(d.Q), smem3 = smem3_for(d.Q);
  // opt in once to the largest shared memory any chunk length needs (the
  // first call comes before any CUDA graph capture of the launch)
  static cudaError_t attr_err = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem1_for(kMaxQ));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        chunk_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem3_for(kMaxQ));
  }();
  if (attr_err != cudaSuccess) return attr_err;
  cudaError_t err;

  chunk_state<T><<<dim3(d.nc, d.H, d.B), kThreads, smem1, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), dacs, states,
      d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pn = d.P * d.N;
  state_pass<<<dim3((pn + kThreads - 1) / kThreads, d.H, d.B), kThreads, 0,
               stream>>>(init, dacs, states, final_state, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_out<T><<<dim3(d.B * d.H, d.nc, (d.Q + kRows - 1) / kRows), kThreads,
                 smem3, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dacs, states, static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y).  init may be null
// (the zero state).  dacs (B*H*nc*Q floats) and states (B*H*nc*P*N
// floats) are scratch the caller allocates.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, void* y, void* final_state, void* dacs,
    void* states, int B, int S, int H, int P, int G, int N, int Q,
    long long x_sb, long long x_ss, long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || Q <= 0 || Q > kMaxQ || G <= 0 || H % G != 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = (S + Q - 1) / Q;
  if (nc > 65535 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  Dims d{B, S, H, P, G, N, Q, nc, H / G, x_sb, x_ss, dt_sb, dt_ss,
         b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_A = static_cast<const float*>(A);
  const float* f_init = static_cast<const float*>(init);
  float* f_fin = static_cast<float*>(final_state);
  float* f_dacs = static_cast<float*>(dacs);
  float* f_states = static_cast<float*>(states);
  cudaError_t err = dtype == 0
      ? launch<float>(x, f_dt, f_A, Bm, Cm, f_init, y, f_fin, f_dacs,
                      f_states, d, s)
      : launch<__nv_bfloat16>(x, f_dt, f_A, Bm, Cm, f_init, y, f_fin, f_dacs,
                              f_states, d, s);
  return (int)err;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
