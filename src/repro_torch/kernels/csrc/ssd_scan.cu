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
// and the state are f32; all sums are f32; y is written in x's type.
// Head h reads group h / (H / G), for any G that divides H.
//
// Bound: operations.  At the mamba2-1.3b serving shape (B 4, S 1024,
// H 64, P 64, N 128, Q 256, G 1) the lower-triangular C.B^T per group,
// the scores times x per head, C.state and the state update are 13 GFLOP
// against 0.16 GB of inputs and outputs.  The TPU kernel walks the chunks
// of one (batch, head block) in order on one core, carrying the state in
// VMEM.  Here the chunks run in parallel instead, in three passes on the
// caller's stream:
//
//   1. chunk_state (grid chunks x heads x batch): da_cs of the chunk by a
//      fixed-order scan (written out for pass 3), and the chunk's own
//      state increment (w x)^T . B, a (P x Q)(Q x N) product over Q tiles
//      staged in shared memory.
//   2. state_pass (grid P*N/256 x heads x batch): the only sequential
//      part, elementwise over the (P, N) state.  Each thread loads the
//      increments and decays of up to kChain chunks before the dependent
//      chain, replaces each chunk's increment by the state entering that
//      chunk and writes the final state.
//   3. chunk_out (grid Q/32 strips x chunks x batch*head blocks): a 32-row
//      strip of one chunk for a block of hblk heads of one group (hblk the
//      largest divisor of H/G up to 8, as the TPU kernel's hblk = 8).  It
//      forms the strip's C.B^T once for the block, 32 rows x up to 256
//      source steps (32 KB f32 in shared memory), then per head and
//      32-step source tile forms L = C.B^T exp(da_cs_i - da_cs_j) dt_j
//      once in shared memory, masked to j <= i before the exp (a positive
//      segment sum is never exponentiated; the upper triangle contributes
//      exactly 0), and adds L.x to exp(da_cs_i) (C.state^T).  A strip of
//      a chunk longer than 256 steps recomputes its C.B^T tiles per head
//      instead.  The Q x Q matrix never exists in device memory.  Its
//      phases (loads, products, L) run between barriers; two blocks an SM
//      overlap them.
//
// Every product runs on the tensor cores (mma.sync m16n8k8, TF32 inputs,
// f32 accumulation) with the 3xTF32 split: an f32 operand is hi + lo, both
// TF32 (cvt.rna), and lo.hi + hi.lo + hi.hi keeps ~f32 accuracy, where
// plain TF32 would keep ~11 bits (kernels/ref.py::ssd_scan_blocked_ref is
// this arithmetic in PyTorch).  bf16 operands are exact in TF32, so their
// lo terms are zero and skipped: C.B^T takes one product a term in bf16.
// Operands that several warps read (B in pass 1, L and x in pass 3) are
// split once, as they are staged or formed.  Tiles come in 16-byte loads
// (8 bytes in bf16) where the rows are aligned to them, the next tile's
// loads flying during the products, and go to shared memory in 16-byte
// stores.  Fragment reads from shared memory use row strides that put
// the 32 lanes on 32 banks.  wgmma and TMA are not used.
//
// Every sum runs in a fixed order and nothing is accumulated with
// atomics, so results are the same bits from run to run, and a null
// init_state reads as zeros through the same arithmetic as explicit
// zeros (bitwise equal).  Steps past S (a ragged last chunk) read as
// dt = 0, x = B = C = 0 and are never written.  Shape envelope: P <= 64,
// N <= 128, Q <= 1024 (the wrapper raises outside it).
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); launches on the caller's stream and
// returns the first failing launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kMaxP = 64;          // the warp tiles cover P <= 64
constexpr int kMaxN = 128;         // and N <= 128
constexpr int kMaxQ = 1024;        // the scan gives each lane <= 32 steps
constexpr int kQT = 32;            // steps per tile in chunk_state
constexpr int kRows = 32;          // chunk rows per chunk_out block
constexpr int kJT = 32;            // source steps per tile in chunk_out
constexpr int kHalfN = 64;         // state columns staged at a time
constexpr int kSpan = 256;         // source steps of C.B^T kept in shared
constexpr int kMaxHblk = 8;        // heads per chunk_out block
constexpr int kChain = 8;          // chunks loaded ahead in state_pass
// Row strides (floats).  A fragment read (row g, col t) of a [row][k]
// tile wants stride = 4 mod 32; a read (row t, col g) of a [k][col] tile
// wants stride = 8 mod 32: the 32 lanes then hit 32 banks.
constexpr int kLdN = kMaxN + 4;    // [row][n] tiles read as (g, t)
constexpr int kLdNB = kMaxN + 8;   // [q][n] tiles read as (t, g)
constexpr int kLdP = kMaxP + 8;    // [step][p] tiles read as (t, g)
constexpr int kLdCB = kSpan + 4;   // [row][j] scores read as (g, t)
constexpr int kLdJ = kJT + 4;      // [row][j] L of one tile, read as (g, t)
constexpr int kLdS = kHalfN + 4;   // [p][n] half the state, read as (g, t)
// chunk_out's tile that holds a C.B^T tile's B rows or half the state
constexpr int kBsFloats =
    kJT * kLdN > kMaxP * kLdS ? kJT * kLdN : kMaxP * kLdS;

struct Dims {
  int B, S, H, P, G, N, Q, nc, rep, hblk;
  int vec_x, vec_b, vec_c, vec_st;   // rows readable 4 elements a load
  long long x_sb, x_ss;    // element strides over batch and step
  long long dt_sb, dt_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &q.x, 4);
  memcpy(&hi, &q.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // round to nearest even, as torch's .to()
}

// ---- tensor-core products ------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32; an exact operand (bf16 data) has lo = 0
template <bool kExact>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = kExact ? 0u : tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[nt] += A (16 x 8*ksteps) . B (8*ksteps x 8 NT) for one warp.
// a_frag(row, k, hi, lo) and b_frag(k, col, hi, lo) give the operands'
// TF32 halves relative to the warp's tile; fragment layout of m16n8k8
// (g = lane/4, t = lane%4): a = (g,t) (g+8,t) (g,t+4) (g+8,t+4);
// b = (t,g) (t+4,g); c = (g,2t) (g,2t+1) (g+8,2t) (g+8,2t+1).  The
// small terms go first.
template <int NT, bool kExactA, bool kExactB, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int ksteps,
                                         FA a_frag, FB b_frag) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 8;
    uint32_t ah[4], al[4];
    a_frag(g, k + t, ah[0], al[0]);
    a_frag(g + 8, k + t, ah[1], al[1]);
    a_frag(g, k + t + 4, ah[2], al[2]);
    a_frag(g + 8, k + t + 4, ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      b_frag(k + t, nt * 8 + g, bh[0], bl[0]);
      b_frag(k + t + 4, nt * 8 + g, bh[1], bl[1]);
      if (!kExactA) mma(acc[nt], al, bh);
      if (!kExactB) mma(acc[nt], ah, bl);
      mma(acc[nt], ah, bh);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
}

// A ROWS x COLS tile in registers, 4 consecutive columns an item and
// kPer items a thread.  read() issues every load of the thread before
// put() writes them, so a tile can be fetched while the previous one is
// being used.  row(r) gives the start of row r, or nullptr for a row of
// zeros; columns from ncols on read as zero.  With vec, an item is one
// 16-byte (f32) or 8-byte (bf16) load: at a few loads in flight a thread,
// the bytes a load brings set the rate.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int kItems = COLS / 4;
  static constexpr int kPer = ROWS * kItems / kThreads;
  static_assert(kPer * kThreads == ROWS * kItems, "tile / threads");
  float4 v[kPer];
  template <typename F>
  __device__ __forceinline__ void read(F row, int ncols, bool vec) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int c = 4 * (e % kItems);
      const auto p = row(e / kItems);
      if (p != nullptr && vec && c + 4 <= ncols) {
        v[k] = load4(p + c);
      } else {
        auto at = [&](int q) {
          return p != nullptr && c + q < ncols ? load(p + c + q) : 0.f;
        };
        v[k] = make_float4(at(0), at(1), at(2), at(3));
      }
    }
  }
  // to(row, col, v) takes the item at columns col .. col + 3
  template <typename F>
  __device__ __forceinline__ void put(F to) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      to(e / kItems, 4 * (e % kItems), v[k]);
    }
  }
};

// 16-byte stores of 4 values into shared memory (dst 16-byte aligned):
// the lanes of a warp write consecutive items, and no bank twice a phase
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
// the TF32 halves of 4 values; lo only where the values are not exact
template <bool kExact>
__device__ __forceinline__ void store4_split(uint32_t* hi, uint32_t* lo,
                                             float4 v) {
  uint4 h, l;
  split<kExact>(v.x, h.x, l.x);
  split<kExact>(v.y, h.y, l.y);
  split<kExact>(v.z, h.z, l.z);
  split<kExact>(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  if (!kExact) *reinterpret_cast<uint4*>(lo) = l;
}

// A ROWS x COLS tile (as Tile::read reads it) into shared memory at row
// stride LD (a multiple of 4), 16 values a thread at a time.
template <int ROWS, int COLS, int LD, typename F>
__device__ __forceinline__ void stage(float* dst, F row, int ncols,
                                      bool vec) {
  constexpr int kRowsPer = 16 * kThreads / COLS;
  static_assert(ROWS % kRowsPer == 0, "rows / pieces");
#pragma unroll 1
  for (int r0 = 0; r0 < ROWS; r0 += kRowsPer) {
    Tile<kRowsPer, COLS> part;
    part.read([&](int r) { return row(r0 + r); }, ncols, vec);
    part.put([&](int r, int c, float4 v) {
      store4(dst + (r0 + r) * LD + c, v);
    });
  }
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

// ---- pass 1 ----------------------------------------------------------------

// Per (chunk, head, batch): da_cs -> dacs_out and the chunk's state
// increment (w x)^T . B -> upd_out (P x N, f32).  Warp w computes rows
// 16 (w % 4) .. of P and columns 64 (w / 4) .. of N.  The next step
// tile's loads fly while the tensor cores work on the current one; B is
// split into its TF32 halves once, as it is staged.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            float* __restrict__ dacs_out, float* __restrict__ upd_out,
            Dims d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                   // kQT x kLdP: w * x
  uint32_t* s_bh = reinterpret_cast<uint32_t*>(s_x + kQT * kLdP);
  uint32_t* s_bl = s_bh + kQT * kLdNB; // kQT x kLdNB each: B's TF32 halves
  float* s_tot = reinterpret_cast<float*>(s_bl + kQT * kLdNB);   // 32
  float* s_da = s_tot + 32;            // Q: dt*A, then its running sum
  float* s_w = s_da + d.Q;             // Q: dt, then the input weights
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / d.rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long s0 = (long long)c * d.Q;
  const T* xh = x + b * d.x_sb + (long long)h * d.P;
  const T* bg = Bm + b * d.b_sb + (long long)g * d.N;

  Tile<kQT, kMaxP> xt;
  Tile<kQT, kMaxN> bt;
  auto fetch = [&](int q0) {
    xt.read([&](int qq) -> const T* {
      const long long s = s0 + q0 + qq;
      return q0 + qq < d.Q && s < d.S ? xh + s * d.x_ss : nullptr;
    }, d.P, d.vec_x);
    bt.read([&](int qq) -> const T* {
      const long long s = s0 + q0 + qq;
      return q0 + qq < d.Q && s < d.S ? bg + s * d.b_ss : nullptr;
    }, d.N, d.vec_b);
  };
  fetch(0);                             // flies during the scan

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

  const int m0 = 16 * (warp % 4), n0 = 64 * (warp / 4);
  const bool busy = m0 < d.P && n0 < d.N;     // the same for the warp
  float acc[8][4];
  zero(acc);
  for (int q0 = 0; q0 < d.Q; q0 += kQT) {
    __syncthreads();              // s_w written / previous tile consumed
    xt.put([&](int qq, int p, float4 v) {
      const int q = q0 + qq;
      const float w = q < d.Q ? s_w[q] : 0.f;
      store4(s_x + qq * kLdP + p,
             make_float4(v.x * w, v.y * w, v.z * w, v.w * w));
    });
    bt.put([&](int qq, int n, float4 v) {
      store4_split<kBf16>(s_bh + qq * kLdNB + n, s_bl + qq * kLdNB + n, v);
    });
    __syncthreads();
    if (q0 + kQT < d.Q) fetch(q0 + kQT);
    if (busy) {
      warp_mma<8, false, kBf16>(
          acc, (min(kQT, d.Q - q0) + 7) / 8,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            split<false>(s_x[k * kLdP + m0 + r], hi, lo);
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_bh[k * kLdNB + n0 + col];
            lo = kBf16 ? 0u : s_bl[k * kLdNB + n0 + col];
          });
    }
  }

  if (!busy) return;
  float* upd = upd_out + ((long long)(b * d.H + h) * d.nc + c) * d.P * d.N;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = m0 + gq + (k / 2) * 8;
      const int n = n0 + nt * 8 + 2 * tq + k % 2;
      if (p < d.P && n < d.N) upd[p * d.N + n] = acc[nt][k];
    }
  }
}

// ---- pass 2 ----------------------------------------------------------------

// Per state element, walk the chunks in order; each chunk's increment is
// replaced by the state entering the chunk.  The loads of kChain chunks
// are issued before their dependent updates.
__global__ void __launch_bounds__(kThreads)
state_pass(const float* __restrict__ init, const float* __restrict__ dacs,
           float* __restrict__ states, float* __restrict__ final_state,
           Dims d) {
  const int pn = d.P * d.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const long long bh = (long long)blockIdx.z * d.H + blockIdx.y;
  if (e >= pn) return;
  float s = init != nullptr ? init[bh * pn + e] : 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += kChain) {
    float u[kChain], tot[kChain];
#pragma unroll
    for (int k = 0; k < kChain; ++k) {
      const int c = c0 + k;
      if (c < d.nc) {
        u[k] = states[(bh * d.nc + c) * pn + e];
        tot[k] = dacs[(bh * d.nc + c) * d.Q + d.Q - 1];
      }
    }
#pragma unroll
    for (int k = 0; k < kChain; ++k) {
      const int c = c0 + k;
      if (c < d.nc) {
        states[(bh * d.nc + c) * pn + e] = s;
        s = s * expf(tot[k]) + u[k];
      }
    }
  }
  final_state[bh * pn + e] = s;
}

// ---- pass 3 ----------------------------------------------------------------

// One 32-row strip of one chunk for hblk heads of one group.  At 97 KB of
// shared memory and at most 128 registers a thread two blocks share an
// SM, so one block's loads and barriers run under the other's products.
// Warp w owns rows 16 (w % 2) .. of the strip and, for each head,
// columns 16 (w / 2) .. of P; in a C.B^T tile, sources 8 (w / 2) .. .
// The first head forms the C.B^T tiles as it reaches them (all of them
// are kept when the strip's sources fit kSpan; else every head forms
// each anew).  Per head, C.state^T takes the state in two halves of N;
// then per source tile all threads form L = C.B^T exp(da_cs_i -
// da_cs_j) dt_j once into shared memory, split into its TF32 halves.
// x is split as it is staged, and the next tile's x loads fly during
// the products.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_out(const T* __restrict__ x, const float* __restrict__ dt,
          const T* __restrict__ Bm, const T* __restrict__ Cm,
          const float* __restrict__ dacs_in, const float* __restrict__ states,
          T* __restrict__ y, Dims d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* s_c = smem;                   // kRows x kLdN: the strip's C rows
  float* s_cb = s_c + kRows * kLdN;    // kRows x kLdCB: C.B^T
  float* s_bs = s_cb + kRows * kLdCB;  // kJT x kLdN B rows, or P x kLdS
  uint32_t* s_lh = reinterpret_cast<uint32_t*>(s_bs + kBsFloats);
  uint32_t* s_ll = s_lh + kRows * kLdJ;   // kRows x kLdJ each: L's halves
  uint32_t* s_xh = s_ll + kRows * kLdJ;
  uint32_t* s_xl = s_xh + kJT * kLdP;  // kJT x kLdP each: x's TF32 halves
  float* s_da = reinterpret_cast<float*>(s_xl + kJT * kLdP);  // Q: da_cs
  float* s_dt = s_da + d.Q;            // Q: dt of one head

  const int strip = gridDim.x - 1 - blockIdx.x;   // the longest strips first
  const int c = blockIdx.y;
  const int nhb = d.H / d.hblk;
  const int b = blockIdx.z / nhb, h0 = (blockIdx.z % nhb) * d.hblk;
  const int g = h0 / d.rep;
  const int i0 = strip * kRows;
  const int i_end = min(i0 + kRows, d.Q);    // rows of the block: [i0, i_end)
  const int nj = (i_end + kJT - 1) / kJT;    // source tiles j < i_end
  const bool cached = i_end <= kSpan;        // C.B^T of all tiles kept
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = 16 * (warp % 2), n0 = 16 * (warp / 2), c0 = 8 * (warp / 2);
  const bool rows_live = m0 < i_end - i0;    // the same for the warp
  const bool live = rows_live && n0 < d.P;
  const int ksn = (d.N + 7) / 8;
  const long long s0 = (long long)c * d.Q;
  const T* bg = Bm + b * d.b_sb + (long long)g * d.N;

  Tile<kJT, kMaxP> xt;                 // the next source tile of x
  auto fetch_x = [&](int h, int jt) {
    const T* xh = x + b * d.x_sb + (long long)h * d.P;
    xt.read([&](int jj) -> const T* {
      const int j = jt * kJT + jj;
      const long long s = s0 + j;
      return j < i_end && s < d.S ? xh + s * d.x_ss : nullptr;
    }, d.P, d.vec_x);
  };
  fetch_x(h0, 0);

  stage<kRows, kMaxN, kLdN>(s_c, [&](int r) -> const T* {
    const int i = i0 + r;
    const long long s = s0 + i;
    return i < i_end && s < d.S
               ? Cm + b * d.c_sb + s * d.c_ss + (long long)g * d.N
               : nullptr;
  }, d.N, d.vec_c);

  // C.B^T of source tile jt into columns col0.. of s_cb (B rows staged)
  auto scores = [&](int jt, int col0) {
    stage<kJT, kMaxN, kLdN>(s_bs, [&](int jj) -> const T* {
      const int j = jt * kJT + jj;
      const long long s = s0 + j;
      return j < i_end && s < d.S ? bg + s * d.b_ss : nullptr;
    }, d.N, d.vec_b);
    __syncthreads();
    if (rows_live) {
      float acc[1][4];
      zero(acc);
      warp_mma<1, kBf16, kBf16>(
          acc, ksn,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            split<kBf16>(s_c[(m0 + r) * kLdN + k], hi, lo);
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            split<kBf16>(s_bs[(c0 + col) * kLdN + k], hi, lo);
          });
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s_cb[(m0 + gq + (k / 2) * 8) * kLdCB + col0 + c0 + 2 * tq + k % 2] =
            acc[0][k];
    }
    __syncthreads();
  };
  for (int hh = 0; hh < d.hblk; ++hh) {
    const int h = h0 + hh;
    const long long bh = (long long)b * d.H + h;
    const float* st = states + (bh * d.nc + c) * d.P * d.N;
    __syncthreads();                  // the previous head's tiles consumed
    const float* dacs = dacs_in + (bh * d.nc + c) * d.Q;
    for (int q = tid; q < i_end; q += kThreads) {
      const long long s = s0 + q;
      s_da[q] = dacs[q];
      s_dt[q] = s < d.S ? dt[b * d.dt_sb + s * d.dt_ss + h] : 0.f;
    }

    // inter-chunk: acc = exp(da_cs_i) * (C . state^T), the state's
    // columns n in halves of kHalfN
    float acc[2][4];
    zero(acc);
    for (int nb = 0; nb < d.N; nb += kHalfN) {
      if (nb > 0) __syncthreads();    // the previous half consumed
      const int nn = min(kHalfN, d.N - nb);
      stage<kMaxP, kHalfN, kLdS>(s_bs, [&](int p) -> const float* {
        return p < d.P ? st + p * d.N + nb : nullptr;
      }, nn, d.vec_st);
      __syncthreads();
      if (live) {
        warp_mma<2, kBf16, false>(
            acc, (nn + 7) / 8,
            [&](int r, int k, uint32_t& hi, uint32_t& lo) {
              split<kBf16>(s_c[(m0 + r) * kLdN + nb + k], hi, lo);
            },
            [&](int k, int col, uint32_t& hi, uint32_t& lo) {
              split<false>(s_bs[(n0 + col) * kLdS + k], hi, lo);
            });
      }
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + m0 + gq + (k / 2) * 8;
        const float decay = i < i_end ? expf(s_da[i]) : 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) acc[nt][k] *= decay;
      }
    }

    // intra-chunk, one source tile of kJT steps at a time
    for (int jt = 0; jt < nj; ++jt) {
      const int j0 = jt * kJT;
      __syncthreads();                // the state / previous tile consumed
      xt.put([&](int jj, int p, float4 v) {
        store4_split<kBf16>(s_xh + jj * kLdP + p, s_xl + jj * kLdP + p, v);
      });
      if (jt + 1 < nj) {
        fetch_x(h, jt + 1);
      } else if (hh + 1 < d.hblk) {
        fetch_x(h + 1, 0);
      }
      const int col0 = cached ? j0 : 0;
      if (!cached || hh == 0) scores(jt, col0);   // synchronizes
      // mask before exp: the segment sum is <= 0 where j <= i.  A thread
      // keeps one source step (column) of the tile.
      {
        const int jj = tid % kJT, j = j0 + jj;
        const float da_j = j < i_end ? s_da[j] : 0.f;
        const float dt_j = j < i_end ? s_dt[j] : 0.f;
#pragma unroll
        for (int r = tid / kJT; r < kRows; r += kThreads / kJT) {
          const int i = i0 + r;
          const float l = (i < i_end && j <= i)
                              ? s_cb[r * kLdCB + col0 + jj] *
                                    expf(s_da[i] - da_j) * dt_j
                              : 0.f;
          split<false>(l, s_lh[r * kLdJ + jj], s_ll[r * kLdJ + jj]);
        }
      }
      __syncthreads();
      if (!live) continue;
      // the diagonal tile: steps past the warp's last row are all masked
      const int kend = j0 == i0 ? min(kJT, m0 + 16) : kJT;
      warp_mma<2, false, kBf16>(
          acc, (min(kend, i_end - j0) + 7) / 8,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            hi = s_lh[(m0 + r) * kLdJ + k];
            lo = s_ll[(m0 + r) * kLdJ + k];
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_xh[k * kLdP + n0 + col];
            lo = kBf16 ? 0u : s_xl[k * kLdP + n0 + col];
          });
    }

    if (!live) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + m0 + gq + (k / 2) * 8;
      const long long s = s0 + i;
      if (i >= i_end || s >= d.S) continue;
      T* yrow = y + ((long long)b * d.S + s) * d.H * d.P + (long long)h * d.P;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int p = n0 + nt * 8 + 2 * tq + k % 2;
        if (p < d.P) store(yrow + p, acc[nt][k]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init, void* y,
                   float* final_state, float* dacs, float* states,
                   const Dims& d, cudaStream_t stream) {
  auto smem1_for = [](int q) {
    return sizeof(float) * (2 * q + kQT * kLdP + 2 * kQT * kLdNB + 32);
  };
  auto smem3_for = [](int q) {
    return sizeof(float) * (kRows * kLdN + kRows * kLdCB + kBsFloats +
                            2 * kRows * kLdJ + 2 * kJT * kLdP + 2 * q);
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
  chunk_out<T><<<dim3((d.Q + kRows - 1) / kRows, d.nc, d.B * (d.H / d.hblk)),
                 kThreads, smem3, stream>>>(
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
  const int rep = H / G;
  int hblk = 1;                       // the largest divisor of H/G <= 8
  for (int k = kMaxHblk; k > 1; --k) {
    if (rep % k == 0) {
      hblk = k;
      break;
    }
  }
  if (nc > 65535 || B > 65535 || H > 65535 ||
      (long long)B * (H / hblk) > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  // rows read 4 elements a load where every row start is aligned to them
  const uintptr_t al = dtype == 0 ? 16 : 8;
  auto rows4 = [&](const void* p, long long sb, long long ss, int off) {
    return (int)((uintptr_t)p % al == 0 && sb % 4 == 0 && ss % 4 == 0 &&
                 off % 4 == 0);
  };
  Dims d{B, S, H, P, G, N, Q, nc, rep, hblk,
         rows4(x, x_sb, x_ss, P), rows4(Bm, b_sb, b_ss, N),
         rows4(Cm, c_sb, c_ss, N), (int)(N % 4 == 0),
         x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
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
