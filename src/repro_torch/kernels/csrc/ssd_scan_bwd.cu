// ssd_scan_bwd — the gradient of Mamba2's SSD chunked scan for Hopper.
//
// Replaces no Pallas kernel: the reference differentiates its plain
// ssd_scan_ref (repro/kernels/ref.py:36) with jax.value_and_grad, the scan
// checkpointed per chunk.  This is that gradient as a kernel, the backward
// of ssd_scan.cu.  Per chunk of Q steps, with cs the running sum of
// da = dt*A inside the chunk, tot its last value, S the state entering
// the chunk, L_ij = exp(cs_i - cs_j) for j <= i and w_j = exp(tot - cs_j)
// dt_j, the forward is
//
//   y_i     = sum_{j<=i} (C_i.B_j) L_ij dt_j x_j + exp(cs_i) S C_i
//   S_next  = exp(tot) S + sum_j w_j x_j (x) B_j
//
// and, given dy and dfinal (the gradient of the final state), the
// gradient dS of each chunk's incoming state satisfies
// dS = exp(tot) dS_next + sum_i exp(cs_i) dy_i (x) C_i, seeded with
// dfinal.  In seven launches on the caller's stream:
//
//   1. bwd_local (chunks x heads x batch): each chunk's
//      sum_i exp(cs_i) dy_i (x) C_i, a (P x Q)(Q x N) product.
//   2. bwd_state (P*N/256 x heads x batch): the only sequential part,
//      elementwise over the (P, N) state, backwards over the chunks: each
//      chunk's local sum is replaced by dS_next, the gradient of the state
//      the chunk leaves; dinit = dS of chunk 0; and per chunk the block's
//      share of <dS_next, S_next>, the gradient of tot.
//   3. bwd_cols (Q/32 strips x chunks x batch*heads): by source step j of
//      a 32-step strip, over the row tiles i >= j: dx_j / dt_j =
//      sum_i (C_i.B_j) L_ij dy_i + exp(tot - cs_j) dS_next B_j, and the
//      head's dB_j = sum_i (dy_i.x_j) L_ij dt_j C_i + w_j dS_next^T x_j,
//      and the column sums of E_ij = (dy_i.x_j)(C_i.B_j) L_ij dt_j.
//   4. bwd_rows (the same grid): by row i of a strip, over the source
//      tiles j <= i: the head's dC_i = sum_j (dy_i.x_j) L_ij dt_j B_j +
//      exp(cs_i) S^T dy_i, and the row sums of E.
//   5. bwd_finish (chunks x heads x batch): d cs = rows - columns of E +
//      C_i.(exp(cs_i) S^T dy_i) - w_j x_j.dS_next B_j, and the gradient of
//      tot at the last step; its reverse running sum is d da; then
//      ddt = x.dx/dt + A d da, and each chunk's share of dA = sum d da dt.
//   6. bwd_reduce_bc: dB and dC summed over the heads of each group, in
//      head order, rounded to x's type.
//   7. bwd_reduce_da: dA summed over batch and chunks, in order.
//
// The forward writes cs (dacs) and the states entering each chunk
// (states) into scratch; the wrapper saves them with the final state, and
// this kernel reads them instead of recomputing the forward's passes.
//
// Bound: operations.  At mamba2-1.3b's training shape (B 4, S 2048, H 64,
// P 64, N 128, Q 256, G 1) the products are 86 GFLOP (43 G multiply-adds)
// against 0.30 GB of inputs, saved scratch and outputs.  This first
// version runs every product in plain f32 on the CUDA cores, its operands
// staged in shared memory a 32-step tile at a time, one output strip per
// thread block; the mask is applied before every exp (a segment sum with
// j > i is never exponentiated).  The masked matrices never exist in
// device memory.  wgmma, mma.sync and TMA are not used.
//
// Every sum runs in a fixed order and nothing is accumulated with atomics:
// the per-head shares of dB and dC and the per-chunk shares of dA and of
// tot's gradient go through scratch and are summed in order by a later
// pass, so results are the same bits from run to run.  Steps past S (a
// ragged last chunk) read as dt = x = B = C = dy = 0, contribute exactly
// nothing and are never written.  Shape envelope: P <= 64, N <= 128,
// Q <= 1024 (the wrapper raises outside it).
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); returns the first failing launch's
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kT = 32;            // steps of a strip and of a tile
// Odd row strides: lanes that read different rows of one column hit
// different banks.
constexpr int kLdP = kMaxP + 1;
constexpr int kLdN = kMaxN + 1;
constexpr int kLdT = kT + 1;
// bwd_cols / bwd_rows shared memory, in floats: the strip's P-wide and
// N-wide rows, then the tile region (a tile's P-wide and N-wide rows and
// two kT x kT score tiles), which the (P, N) state reuses after the tiles
static_assert(kT * kLdP + kT * kLdN + 2 * kT * kLdT >= kMaxP * kLdN,
              "the state fits the tile region");
constexpr int kStrip = kT * kLdP + kT * kLdN;
constexpr int kTiles = kT * kLdP + kT * kLdN + 2 * kT * kLdT;
constexpr int kRed = 3 * kWarps * kT;

struct Dims {
  int B, S, H, P, G, N, Q, nc, rep, nblk;
  long long x_sb, x_ss;    // element strides over batch and step
  long long dt_sb, dt_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // round to nearest even, as torch's .to()
}

// Rows r < kT of a [step][width] slice into dst at row stride ldd: row r
// is chunk step q0 + r (absolute step s0 + r), read from base + s * ss
// while it lies in the chunk and before S, else zeros.  Consecutive
// threads read consecutive elements of a row.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ldd, const T* base,
                                           long long ss, long long s0, int q0,
                                           int width, const Dims& d) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, k = e % width;
    const long long s = s0 + r;
    dst[r * ldd + k] =
        q0 + r < d.Q && s < d.S ? ld(base + s * ss + k) : 0.f;
  }
}

// The reverse of stage_rows: rows in the chunk and before S are written.
template <typename T>
__device__ __forceinline__ void write_rows(T* base, long long ss, long long s0,
                                           int q0, const float* src, int lds,
                                           int width, const Dims& d) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, k = e % width;
    const long long s = s0 + r;
    if (q0 + r < d.Q && s < d.S) st(base + s * ss + k, src[r * lds + k]);
  }
}

// The sum over the 8 warps, in warp order, of part[w][lane]: thread
// lane < kT returns it.  Call with all threads.
__device__ __forceinline__ float warp_sum(float* part, float v) {
  part[threadIdx.x] = v;               // [warp][lane]
  __syncthreads();
  float acc = 0.f;
  if (threadIdx.x < kT) {
    for (int w = 0; w < kWarps; ++w) acc += part[w * kT + threadIdx.x];
  }
  return acc;
}

// ---- pass 1 ----------------------------------------------------------------

// Per (chunk, head, batch): local = sum_i exp(cs_i) dy_i (x) C_i into
// dstates (P x N).  Thread (warp w, lane l) keeps p = w + 8m, n = l + 32a.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_local(const T* __restrict__ dy, const T* __restrict__ Cm,
          const float* __restrict__ dacs, float* __restrict__ dstates,
          Dims d) {
  __shared__ float s_dy[kT * kLdP];
  __shared__ float s_c[kT * kLdN];
  __shared__ float s_e[kT];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = (long long)b * d.H + h;
  const float* cs = dacs + (bh * d.nc + c) * d.Q;
  const long long dy_ss = (long long)d.H * d.P;
  const T* dyh = dy + (long long)b * d.S * dy_ss + (long long)h * d.P;
  const T* cg = Cm + b * d.c_sb + (long long)(h / d.rep) * d.N;
  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[m][a] = 0.f;
  for (int q0 = 0; q0 < d.Q; q0 += kT) {
    const long long s0 = (long long)c * d.Q + q0;
    __syncthreads();                   // the previous tile consumed
    stage_rows(s_dy, kLdP, dyh, dy_ss, s0, q0, d.P, d);
    stage_rows(s_c, kLdN, cg, d.c_ss, s0, q0, d.N, d);
    if (tid < kT) s_e[tid] = q0 + tid < d.Q ? expf(cs[q0 + tid]) : 0.f;
    __syncthreads();
    const int rows = min(kT, d.Q - q0);
    for (int r = 0; r < rows; ++r) {
      float cv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int n = lane + 32 * a;
        cv[a] = n < d.N ? s_c[r * kLdN + n] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int p = warp + 8 * m;
        const float v = p < d.P ? s_e[r] * s_dy[r * kLdP + p] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[m][a] += v * cv[a];
      }
    }
  }
  float* out = dstates + (bh * d.nc + c) * d.P * d.N;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = warp + 8 * m;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = lane + 32 * a;
      if (p < d.P && n < d.N) out[p * d.N + n] = acc[m][a];
    }
  }
}

// ---- pass 2 ----------------------------------------------------------------

// Per state element, backwards over the chunks: chunk c's local sum is
// replaced by ds = dS_{c+1}, then ds <- ds exp(tot_c) + local_c.  Each
// block also writes, per chunk, the sum of ds * S_{c+1} over its 256
// elements (a fixed tree); bwd_finish adds the blocks' sums in order.
__global__ void __launch_bounds__(kThreads)
bwd_state(const float* __restrict__ dacs, const float* __restrict__ states,
          const float* __restrict__ final_state,
          const float* __restrict__ dfinal, float* __restrict__ dstates,
          float* __restrict__ dinit, float* __restrict__ dtot_part, Dims d) {
  __shared__ float red[kThreads];
  const int pn = d.P * d.N;
  const int tid = threadIdx.x;
  const int e = blockIdx.x * kThreads + tid;
  const bool on = e < pn;
  const long long bh = (long long)blockIdx.z * d.H + blockIdx.y;
  float ds = on && dfinal != nullptr ? dfinal[bh * pn + e] : 0.f;
  for (int c = d.nc - 1; c >= 0; --c) {
    const long long at = (bh * d.nc + c) * pn + e;
    float loc = 0.f, nxt = 0.f;
    if (on) {
      loc = dstates[at];
      nxt = c + 1 < d.nc ? states[at + pn] : final_state[bh * pn + e];
      dstates[at] = ds;
    }
    red[tid] = ds * nxt;
    __syncthreads();
    for (int k = kThreads / 2; k > 0; k >>= 1) {
      if (tid < k) red[tid] += red[tid + k];
      __syncthreads();
    }
    if (tid == 0) {
      dtot_part[(bh * d.nblk + blockIdx.x) * d.nc + c] = red[0];
    }
    __syncthreads();                   // red[0] read before it is rewritten
    const float tot = dacs[(bh * d.nc + c) * d.Q + d.Q - 1];
    ds = ds * expf(tot) + loc;
  }
  if (on) dinit[bh * pn + e] = ds;
}

// ---- pass 3 ----------------------------------------------------------------

// Shared memory of bwd_cols and bwd_rows: the strip's rows (sp, sn), the
// tile region (tp, tn, t1, t2; the (P, N) state after the tiles), then
// cs and dt of the chunk and the cross-warp partial sums.
struct Smem {
  float *sp, *sn, *tp, *tn, *t1, *t2, *state, *cs, *dt, *red;
  __device__ explicit Smem(float* base, int Q) {
    sp = base;
    sn = sp + kT * kLdP;
    tp = sn + kT * kLdN;
    tn = tp + kT * kLdP;
    t1 = tn + kT * kLdN;
    t2 = t1 + kT * kLdT;
    state = tp;
    cs = base + kStrip + kTiles;
    dt = cs + Q;
    red = dt + Q;
  }
};

__device__ __forceinline__ void load_chunk(const Smem& sm, const float* cs,
                                           const float* dt, long long s0,
                                           const Dims& d) {
  for (int q = threadIdx.x; q < d.Q; q += kThreads) {
    const long long s = s0 + q;
    sm.cs[q] = cs[q];
    sm.dt[q] = s < d.S ? dt[s * d.dt_ss] : 0.f;
  }
}

// (P, N) state at src into sm.state at row stride kLdN
__device__ __forceinline__ void stage_state(const Smem& sm, const float* src,
                                            const Dims& d) {
  for (int e = threadIdx.x; e < d.P * d.N; e += kThreads) {
    sm.state[(e / d.N) * kLdN + e % d.N] = src[e];
  }
}

// One 32-step strip of source steps j of one chunk and head.  Thread
// (warp w, lane l) keeps source step j0 + l: in a score tile rows
// w + 8k, in the outputs p = w + 8m and n = w + 8m.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_cols(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ Bm, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ dacs,
         const float* __restrict__ dstates, T* __restrict__ dx,
         float* __restrict__ dBh, float* __restrict__ ddt_dir,
         float* __restrict__ dcs_col, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, d.Q);
  const int strip = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / d.H, h = blockIdx.z % d.H, g = h / d.rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = (long long)b * d.H + h;
  const long long cq = (long long)c * d.Q;
  const int j0 = strip * kT;
  const long long dy_ss = (long long)d.H * d.P;
  const T* xh = x + b * d.x_sb + (long long)h * d.P;
  const T* bg = Bm + b * d.b_sb + (long long)g * d.N;
  const T* cg = Cm + b * d.c_sb + (long long)g * d.N;
  const T* dyh = dy + (long long)b * d.S * dy_ss + (long long)h * d.P;

  load_chunk(sm, dacs + (bh * d.nc + c) * d.Q, dt + b * d.dt_sb + h, cq, d);
  stage_rows(sm.sp, kLdP, xh, d.x_ss, cq + j0, j0, d.P, d);
  stage_rows(sm.sn, kLdN, bg, d.b_ss, cq + j0, j0, d.N, d);

  const int j = j0 + lane;
  float dxu[8], db[16], col_e = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) dxu[m] = 0.f;
#pragma unroll
  for (int m = 0; m < 16; ++m) db[m] = 0.f;
  for (int i0 = j0; i0 < d.Q; i0 += kT) {
    __syncthreads();                   // the previous tile consumed
    stage_rows(sm.tp, kLdP, dyh, dy_ss, cq + i0, i0, d.P, d);
    stage_rows(sm.tn, kLdN, cg, d.c_ss, cq + i0, i0, d.N, d);
    __syncthreads();
    // the scores of rows i = i0 + warp + 8k against source j, masked
    // to j <= i before the exp
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int il = warp + 8 * k, i = i0 + il;
      float t1 = 0.f, t2 = 0.f;
      if (i < d.Q && j <= i) {
        float cb = 0.f, dyx = 0.f;
        for (int n = 0; n < d.N; ++n)
          cb += sm.tn[il * kLdN + n] * sm.sn[lane * kLdN + n];
        for (int p = 0; p < d.P; ++p)
          dyx += sm.tp[il * kLdP + p] * sm.sp[lane * kLdP + p];
        const float l = expf(sm.cs[i] - sm.cs[j]);
        t1 = cb * l;
        t2 = dyx * l * sm.dt[j];
        col_e += t2 * cb;
      }
      sm.t1[il * kLdT + lane] = t1;
      sm.t2[il * kLdT + lane] = t2;
    }
    __syncthreads();
    const int rows = min(kT, d.Q - i0);
    for (int il = 0; il < rows; ++il) {
      const float t1 = sm.t1[il * kLdT + lane];
      const float t2 = sm.t2[il * kLdT + lane];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int p = warp + 8 * m;
        if (p < d.P) dxu[m] += t1 * sm.tp[il * kLdP + p];
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int n = warp + 8 * m;
        if (n < d.N) db[m] += t2 * sm.tn[il * kLdN + n];
      }
    }
  }

  // the state's terms: v = dS_next B_j and dS_next^T x_j
  __syncthreads();
  stage_state(sm, dstates + (bh * d.nc + c) * d.P * d.N, d);
  __syncthreads();
  const bool jv = j < d.Q;
  const float tot = sm.cs[d.Q - 1];
  const float decay = jv ? expf(tot - sm.cs[j]) : 0.f;
  const float w = jv ? decay * sm.dt[j] : 0.f;
  float part_ddt = 0.f, part_xv = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = warp + 8 * m;
    if (p >= d.P) continue;
    float v = 0.f;
    for (int n = 0; n < d.N; ++n)
      v += sm.state[p * kLdN + n] * sm.sn[lane * kLdN + n];
    dxu[m] += decay * v;
    const float xj = sm.sp[lane * kLdP + p];
    part_ddt += xj * dxu[m];
    part_xv += xj * v;
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int n = warp + 8 * m;
    if (n >= d.N) continue;
    float u = 0.f;
    for (int p = 0; p < d.P; ++p)
      u += sm.state[p * kLdN + n] * sm.sp[lane * kLdP + p];
    db[m] += w * u;
  }
  const float dtj = jv ? sm.dt[j] : 0.f;
  const float sum_ddt = warp_sum(sm.red, part_ddt);
  const float sum_xv = warp_sum(sm.red + kWarps * kT, part_xv);
  const float sum_e = warp_sum(sm.red + 2 * kWarps * kT, col_e);
  if (tid < kT && jv) {
    const long long at = (bh * d.nc + c) * d.Q + j;
    ddt_dir[at] = sum_ddt;
    dcs_col[at] = -sum_e - w * sum_xv;
  }
  __syncthreads();                     // the state read: reuse the region
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = warp + 8 * m;
    if (p < d.P) sm.tp[lane * kLdP + p] = dtj * dxu[m];
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int n = warp + 8 * m;
    if (n < d.N) sm.tn[lane * kLdN + n] = db[m];
  }
  __syncthreads();
  write_rows(dx + (long long)b * d.S * dy_ss + (long long)h * d.P, dy_ss,
             cq + j0, j0, sm.tp, kLdP, d.P, d);
  const long long bn_ss = (long long)d.H * d.N;
  write_rows(dBh + (long long)b * d.S * bn_ss + (long long)h * d.N, bn_ss,
             cq + j0, j0, sm.tn, kLdN, d.N, d);
}

// One 32-step strip of rows i of one chunk and head.  Thread (warp w,
// lane l) keeps row i0 + l: in a score tile sources w + 8k, in the
// outputs n = w + 8m.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_rows(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ Bm, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ dacs,
         const float* __restrict__ states, float* __restrict__ dCh,
         float* __restrict__ dcs_row, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, d.Q);
  const int strip = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / d.H, h = blockIdx.z % d.H, g = h / d.rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = (long long)b * d.H + h;
  const long long cq = (long long)c * d.Q;
  const int i0 = strip * kT;
  const long long dy_ss = (long long)d.H * d.P;
  const T* xh = x + b * d.x_sb + (long long)h * d.P;
  const T* bg = Bm + b * d.b_sb + (long long)g * d.N;
  const T* cg = Cm + b * d.c_sb + (long long)g * d.N;
  const T* dyh = dy + (long long)b * d.S * dy_ss + (long long)h * d.P;

  load_chunk(sm, dacs + (bh * d.nc + c) * d.Q, dt + b * d.dt_sb + h, cq, d);
  stage_rows(sm.sp, kLdP, dyh, dy_ss, cq + i0, i0, d.P, d);
  stage_rows(sm.sn, kLdN, cg, d.c_ss, cq + i0, i0, d.N, d);

  const int i = i0 + lane;
  float dc[16], row_e = 0.f;
#pragma unroll
  for (int m = 0; m < 16; ++m) dc[m] = 0.f;
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    __syncthreads();                   // the previous tile consumed
    stage_rows(sm.tp, kLdP, xh, d.x_ss, cq + j0, j0, d.P, d);
    stage_rows(sm.tn, kLdN, bg, d.b_ss, cq + j0, j0, d.N, d);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int jl = warp + 8 * k, j = j0 + jl;
      float t2 = 0.f;
      if (i < d.Q && j <= i) {
        float cb = 0.f, dyx = 0.f;
        for (int n = 0; n < d.N; ++n)
          cb += sm.sn[lane * kLdN + n] * sm.tn[jl * kLdN + n];
        for (int p = 0; p < d.P; ++p)
          dyx += sm.sp[lane * kLdP + p] * sm.tp[jl * kLdP + p];
        t2 = dyx * expf(sm.cs[i] - sm.cs[j]) * sm.dt[j];
        row_e += t2 * cb;
      }
      sm.t2[jl * kLdT + lane] = t2;
    }
    __syncthreads();
    const int cols = min(kT, d.Q - j0);
    for (int jl = 0; jl < cols; ++jl) {
      const float t2 = sm.t2[jl * kLdT + lane];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int n = warp + 8 * m;
        if (n < d.N) dc[m] += t2 * sm.tn[jl * kLdN + n];
      }
    }
  }

  // the inter-chunk term: exp(cs_i) S^T dy_i
  __syncthreads();
  stage_state(sm, states + (bh * d.nc + c) * d.P * d.N, d);
  __syncthreads();
  const bool iv = i < d.Q;
  const float e = iv ? expf(sm.cs[i]) : 0.f;
  float part_c = 0.f;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int n = warp + 8 * m;
    if (n >= d.N) continue;
    float u = 0.f;
    for (int p = 0; p < d.P; ++p)
      u += sm.sp[lane * kLdP + p] * sm.state[p * kLdN + n];
    const float dci = e * u;
    dc[m] += dci;
    part_c += sm.sn[lane * kLdN + n] * dci;
  }
  const float sum_e = warp_sum(sm.red, row_e);
  const float sum_c = warp_sum(sm.red + kWarps * kT, part_c);
  if (tid < kT && iv) {
    dcs_row[(bh * d.nc + c) * d.Q + i] = sum_e + sum_c;
  }
  __syncthreads();                     // the state read: reuse the region
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int n = warp + 8 * m;
    if (n < d.N) sm.tn[lane * kLdN + n] = dc[m];
  }
  __syncthreads();
  const long long bn_ss = (long long)d.H * d.N;
  write_rows(dCh + (long long)b * d.S * bn_ss + (long long)h * d.N, bn_ss,
             cq + i0, i0, sm.tn, kLdN, d.N, d);
}

// ---- pass 4 ----------------------------------------------------------------

// v[k] <- sum_{q >= k} v[q] over v[0..n), in a fixed order: lane l of
// warp 0 sums the l-th run of steps counted from the end, lane 0 adds the
// run totals in order, each run adds its offset.  Ends synchronized.
__device__ void reverse_running_sum(float* v, int n, float* totals) {
  const int lane = threadIdx.x;
  const int len = (n + 31) / 32;
  const int lo = min(lane * len, n), hi = min(lo + len, n);
  if (threadIdx.x < 32) {
    float run = 0.f;
    for (int r = lo; r < hi; ++r) {
      run += v[n - 1 - r];
      v[n - 1 - r] = run;
    }
    totals[lane] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int k = 0; k < 32; ++k) {
      const float t = totals[k];
      totals[k] = acc;
      acc += t;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32 && lane > 0) {
    const float off = totals[lane];
    for (int r = lo; r < hi; ++r) v[n - 1 - r] = off + v[n - 1 - r];
  }
  __syncthreads();
}

// Per (chunk, head, batch): d cs -> d da -> ddt, and the chunk's share
// of dA.
__global__ void __launch_bounds__(kThreads)
bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ dcs_row,
           const float* __restrict__ dcs_col,
           const float* __restrict__ ddt_dir,
           const float* __restrict__ dtot_part, float* __restrict__ ddt,
           float* __restrict__ da_part, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* v = smem;                     // Q
  float* totals = v + d.Q;             // 32
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * d.H + h;
  const long long at = (bh * d.nc + c) * d.Q;
  const long long cq = (long long)c * d.Q;
  for (int q = threadIdx.x; q < d.Q; q += kThreads) {
    // padded steps were never written: their shares are zero
    v[q] = cq + q < d.S ? dcs_row[at + q] + dcs_col[at + q] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float g = 0.f;                     // the gradient of tot, block order
    for (int k = 0; k < d.nblk; ++k) g += dtot_part[(bh * d.nblk + k) * d.nc + c];
    v[d.Q - 1] += g;
  }
  __syncthreads();
  reverse_running_sum(v, d.Q, totals);
  const float a = A[h];
  const float* dtb = dt + b * d.dt_sb + h;
  for (int q = threadIdx.x; q < d.Q; q += kThreads) {
    const long long s = cq + q;
    if (s < d.S) ddt[(b * (long long)d.S + s) * d.H + h] =
        ddt_dir[at + q] + v[q] * a;
  }
  // dA's share: lane l sums its run of d da * dt, lane 0 the runs in order
  __syncthreads();
  const int len = (d.Q + 31) / 32;
  if (threadIdx.x < 32) {
    const int lo = min((int)threadIdx.x * len, d.Q), hi = min(lo + len, d.Q);
    float run = 0.f;
    for (int q = lo; q < hi; ++q) {
      const long long s = cq + q;
      if (s < d.S) run += v[q] * dtb[s * d.dt_ss];
    }
    totals[threadIdx.x] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int k = 0; k < 32; ++k) acc += totals[k];
    da_part[bh * d.nc + c] = acc;
  }
}

// dB (blockIdx.y 0) and dC (1): the heads of each group summed in head
// order, into (B, S, G, N) of x's type.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_bc(const float* __restrict__ dBh, const float* __restrict__ dCh,
              T* __restrict__ dB, T* __restrict__ dC, Dims d) {
  const long long total = (long long)d.B * d.S * d.G * d.N;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const float* src = blockIdx.y == 0 ? dBh : dCh;
  T* dst = blockIdx.y == 0 ? dB : dC;
  const int n = (int)(e % d.N);
  const long long sg = e / d.N;        // (b * S + s) * G + g
  const int g = (int)(sg % d.G);
  const long long bs = sg / d.G;
  const float* row = src + (bs * d.H + (long long)g * d.rep) * d.N + n;
  float acc = 0.f;
  for (int k = 0; k < d.rep; ++k) acc += row[(long long)k * d.N];
  st(dst + e, acc);
}

// dA[h]: the chunks' shares summed over batch, then chunks, in order.
__global__ void __launch_bounds__(kThreads)
bwd_reduce_da(const float* __restrict__ da_part, float* __restrict__ dA,
              Dims d) {
  for (int h = threadIdx.x; h < d.H; h += kThreads) {
    float acc = 0.f;
    for (int b = 0; b < d.B; ++b)
      for (int c = 0; c < d.nc; ++c)
        acc += da_part[((long long)b * d.H + h) * d.nc + c];
    dA[h] = acc;
  }
}

size_t tiles_smem(int Q) {
  return sizeof(float) * (kStrip + kTiles + 2 * Q + kRed);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const void* dy,
                   const float* dfinal, const float* dacs,
                   const float* states, const float* final_state, void* dx,
                   float* ddt, float* dA, void* dB, void* dC, float* dinit,
                   float* dstates, float* dtot_part, float* rows_cols,
                   float* dbc_heads, float* da_part, const Dims& d,
                   cudaStream_t stream) {
  // opt in once to the largest shared memory any chunk length needs (the
  // first call comes before any CUDA graph capture of the launch)
  static cudaError_t attr_err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_cols<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tiles_smem(kMaxQ));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tiles_smem(kMaxQ));
  }();
  if (attr_err != cudaSuccess) return attr_err;
  const T* tx = static_cast<const T*>(x);
  const T* tb = static_cast<const T*>(Bm);
  const T* tc = static_cast<const T*>(Cm);
  const T* tdy = static_cast<const T*>(dy);
  const long long plane = (long long)d.B * d.H * d.nc * d.Q;
  float* dcs_row = rows_cols;
  float* dcs_col = rows_cols + plane;
  float* ddt_dir = rows_cols + 2 * plane;
  float* dBh = dbc_heads;
  float* dCh = dbc_heads + (long long)d.B * d.S * d.H * d.N;
  cudaError_t err;

  bwd_local<T><<<dim3(d.nc, d.H, d.B), kThreads, 0, stream>>>(
      tdy, tc, dacs, dstates, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_state<<<dim3(d.nblk, d.H, d.B), kThreads, 0, stream>>>(
      dacs, states, final_state, dfinal, dstates, dinit, dtot_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 strips((d.Q + kT - 1) / kT, d.nc, d.B * d.H);
  const size_t smem = tiles_smem(d.Q);
  bwd_cols<T><<<strips, kThreads, smem, stream>>>(
      tx, dt, tb, tc, tdy, dacs, dstates, static_cast<T*>(dx), dBh, ddt_dir,
      dcs_col, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_rows<T><<<strips, kThreads, smem, stream>>>(
      tx, dt, tb, tc, tdy, dacs, states, dCh, dcs_row, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_finish<<<dim3(d.nc, d.H, d.B), kThreads,
               sizeof(float) * (d.Q + 32), stream>>>(
      dt, A, dcs_row, dcs_col, ddt_dir, dtot_part, ddt, da_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long bc = (long long)d.B * d.S * d.G * d.N;
  bwd_reduce_bc<T><<<dim3((unsigned)((bc + kThreads - 1) / kThreads), 2),
                     kThreads, 0, stream>>>(dBh, dCh, static_cast<T*>(dB),
                                            static_cast<T*>(dC), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_reduce_da<<<1, kThreads, 0, stream>>>(da_part, dA, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, dy, dx, dB and dC).  dy,
// dfinal, states and final_state are dense; x, dt, Bm and Cm strided over
// batch and step as in ssd_scan_launch.  dfinal may be null (zero).
// Scratch the caller allocates, in floats: dstates B*H*nc*P*N, dtot_part
// B*H*nblk*nc (nblk = ceil(P*N / 256)), rows_cols 3*B*H*nc*Q, dbc_heads
// 2*B*S*H*N, da_part B*H*nc.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* dacs,
    const void* states, const void* final_state, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, void* dstates,
    void* dtot_part, void* rows_cols, void* dbc_heads, void* da_part, int B,
    int S, int H, int P, int G, int N, int Q, long long x_sb, long long x_ss,
    long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || Q <= 0 || Q > kMaxQ || G <= 0 || H % G != 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = (S + Q - 1) / Q;
  if (nc > 65535 || B > 65535 || H > 65535 ||
      (long long)B * H > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int nblk = (P * N + kThreads - 1) / kThreads;
  Dims d{B, S, H, P, G, N, Q, nc, H / G, nblk,
         x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err = dtype == 0
      ? launch<float>(x, f(dt), f(A), Bm, Cm, dy, f(dfinal), f(dacs),
                      f(states), f(final_state), dx, w(ddt), w(dA), dB, dC,
                      w(dinit), w(dstates), w(dtot_part), w(rows_cols),
                      w(dbc_heads), w(da_part), d, s)
      : launch<__nv_bfloat16>(x, f(dt), f(A), Bm, Cm, dy, f(dfinal),
                              f(dacs), f(states), f(final_state), dx, w(ddt),
                              w(dA), dB, dC, w(dinit), w(dstates),
                              w(dtot_part), w(rows_cols), w(dbc_heads),
                              w(da_part), d, s);
  return (int)err;
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
