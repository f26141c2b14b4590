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
// dfinal.  With the scores t1_ij = (C_i.B_j) L_ij and t2_ij = (dy_i.x_j)
// L_ij dt_j, in seven launches on the caller's stream:
//
//   1. bwd_local (chunks x heads x batch): each chunk's
//      sum_i exp(cs_i) dy_i (x) C_i, a (P x Q)(Q x N) product.
//   2. bwd_state (P*N/256 x heads x batch): the only sequential part,
//      elementwise over the (P, N) state, backwards over the chunks: each
//      chunk's local sum is replaced by dS_next, the gradient of the state
//      the chunk leaves; dinit = dS of chunk 0; and per chunk the block's
//      share of <dS_next, S_next>, the gradient of tot.
//   3. bwd_cols (chunks*batch*head blocks x Q/32 strips): a 32-step strip
//      of source steps j for a block of hblk heads of one group, over the
//      row tiles i >= j: per head dx_j = dt_j (t1^T dy + exp(tot - cs_j)
//      dS_next B_j), the block's dB_j = sum over its heads of (t2^T C +
//      w_j dS_next^T x_j), and the column sums of E = t2 (C.B^T).
//   4. bwd_rows (the same grid): a 32-step strip of rows i for the same
//      head block, over the source tiles j <= i: the block's dC_i = sum
//      over its heads of (t2 B + exp(cs_i) S^T dy_i), and the row sums of E.
//   5. bwd_finish (chunks x heads x batch): d cs = rows - columns of E +
//      C_i.(exp(cs_i) S^T dy_i) - w_j x_j.dS_next B_j, and the gradient of
//      tot at the last step; its reverse running sum is d da; then
//      ddt = x.dx/dt + A d da, and each chunk's share of dA = sum d da dt.
//   6. bwd_reduce_bc: the head blocks' dB and dC shares summed over each
//      group in order, rounded to x's type.
//   7. bwd_reduce_da: dA summed over batch and chunks, in order.
//
// The forward writes cs (dacs) and the states entering each chunk
// (states) into scratch; the wrapper saves them with the final state, and
// this kernel reads them instead of recomputing the forward's passes.
//
// Bound: operations.  At mamba2-1.3b's training shape (B 4, S 2048, H 64,
// P 64, N 128, Q 256, G 1) the products are 86 GFLOP (43 G multiply-adds)
// against 0.30 GB of inputs, saved scratch and outputs.  What the design
// does about it:
//
//   - Every product runs on the tensor cores, mma.sync m16n8k8 with TF32
//     inputs and f32 sums: the scores C.B^T and dy.x^T, the outputs t1^T
//     dy, t2^T C and t2 B, the state terms dS B, dS^T x and S^T dy, and
//     bwd_local's (exp(cs) dy)^T C.  An f32 operand is split into TF32
//     halves hi + lo and lo.hi + hi.lo + hi.hi keeps ~f32 accuracy
//     (3xTF32; plain TF32 keeps ~11 bits, which misses the tolerance).  A
//     bf16 operand is exact in TF32, its lo is zero and its term skipped:
//     in bf16, C.B^T and dy.x^T take one product a term, and the outputs
//     and state terms two (the scores t1, t2, the exp(cs)-scaled rows and
//     the states are f32); in f32 every product takes three.  Each
//     operand is split once, as it is staged in shared memory or formed
//     (t1 and t2 straight from the score fragments), never per warp.
//   - Register-blocked tiles: each warp keeps 16 x 8 fragments of its
//     outputs and of the score tile in registers; the mask j <= i is
//     applied before the exp on the fragment, which then goes to shared
//     memory split, where the next product reads it (transposed, in
//     bwd_cols).  The next tile's loads (16 bytes a load in f32, 8 in
//     bf16, where the rows are aligned to them) are in flight during the
//     products, but for bwd_cols's C rows, read at the tile's start to
//     stay under the register cap.  x, B and C are read in place as
//     strided views of one projection.  wgmma and TMA are not used: TF32 wgmma takes both
//     operands K-major, which t1^T dy, t2^T C and dS^T x are not as
//     staged here.
//   - One C.B^T per head block: a block covers hblk heads of one group
//     (the caller's choice, at most 8 and a divisor of H/G; the wrapper
//     takes the largest, as the forward's chunk_out does) and forms each
//     C.B^T tile once for all of them, kept per thread in shared memory
//     while a strip spans at most 256 steps (longer chunks form it again
//     per head).  The strips that walk the most
//     tiles are launched first.
//   - dB and dC are summed over the head block in registers, in head
//     order; only H/(G hblk) shares a group go through scratch.
//
// Every sum runs in a fixed order and nothing is accumulated with atomics:
// the head blocks' dB and dC shares and the per-chunk shares of dA and of
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

#include <type_traits>

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kT = 32;            // steps of a strip and of a tile
constexpr int kSpan = 256;        // steps of C.B^T a strip keeps
constexpr int kSpanTiles = kSpan / kT;
constexpr int kMaxHblk = 8;       // heads per block
constexpr int kChain = 8;         // chunks loaded ahead in bwd_state
// Row strides (words).  A fragment read (row g, col t) of a [row][k]
// tile wants stride = 4 mod 32; a read (row t, col g) of a [k][col] tile
// wants stride = 8 mod 32: the 32 lanes then hit 32 banks.  A tile read
// both ways takes the stride of its more frequent read (C.B^T runs at the
// first head only); the other read meets 2-way conflicts.
constexpr int kLdP4 = kMaxP + 4;  // [step][p] read as (g, t)
constexpr int kLdP8 = kMaxP + 8;  // [step][p] read as (t, g)
constexpr int kLdN4 = kMaxN + 4;  // [step][n] read as (g, t)
constexpr int kLdN8 = kMaxN + 8;  // [step][n] read as (t, g)
constexpr int kLdT4 = kT + 4;     // [i][j] scores read as (g, t)
constexpr int kLdT8 = kT + 8;     // [i][j] scores read as (t, g)

struct Dims {
  int B, S, H, P, G, N, Q, nc, rep, nblk, hblk, nhb;
  int vec_x, vec_b, vec_c, vec_dy, vec_st;   // rows readable 4 a load
  long long x_sb, x_ss;    // element strides over batch and step
  long long dt_sb, dt_ss;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // round to nearest even, as torch's .to()
}

// ---- tensor-core products (as ssd_scan.cu) --------------------------------

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32; an exact operand (bf16 data) is its own hi
template <bool kExact>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = kExact ? __float_as_uint(v) : tf32(v);
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

// acc[nt] += A . B over k-steps ks0 .. ks1 - 1 (8 deep each), A 16
// rows and B 8 NT columns, for one warp.
// a_frag(row, k, hi, lo) and b_frag(k, col, hi, lo) give the operands'
// TF32 halves relative to the warp's tile; fragment layout of m16n8k8
// (g = lane/4, t = lane%4): a = (g,t) (g+8,t) (g,t+4) (g+8,t+4);
// b = (t,g) (t+4,g); c = (g,2t) (g,2t+1) (g+8,2t) (g+8,2t+1).  The
// small terms go first; an exact operand's lo term is skipped.
template <int NT, bool kExactA, bool kExactB, bool kRolled = false,
          typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int ks0,
                                         int ks1, FA a_frag, FB b_frag) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  auto step = [&](int ks) {
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
  };
  if (kRolled) {                      // one k-step in flight: fewer registers
#pragma unroll 1
    for (int ks = ks0; ks < ks1; ++ks) step(ks);
  } else {
    for (int ks = ks0; ks < ks1; ++ks) step(ks);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
}

// Four consecutive values of T as one load brings them: a float4, or
// four bf16 packed in a uint2 (half the registers while a tile is in
// flight), widened to f32 when the tile is put into shared memory.
template <typename T>
struct Raw4 {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 q) {
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}
// values c .. c + 3 of the row at p, zero from ncols on; with vec one
// 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 load_raw(const float* p, int c, int ncols,
                                           bool vec) {
  if (vec && c + 4 <= ncols)
    return __ldg(reinterpret_cast<const float4*>(p + c));
  auto at = [&](int q) { return c + q < ncols ? __ldg(p + c + q) : 0.f; };
  return make_float4(at(0), at(1), at(2), at(3));
}
__device__ __forceinline__ uint2 load_raw(const __nv_bfloat16* p, int c,
                                          int ncols, bool vec) {
  if (vec && c + 4 <= ncols)
    return __ldg(reinterpret_cast<const uint2*>(p + c));
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  auto at = [&](int q) -> uint32_t { return c + q < ncols ? u[c + q] : 0u; };
  return make_uint2(at(0) | at(1) << 16, at(2) | at(3) << 16);
}

// A ROWS x COLS tile of T in registers, 4 consecutive columns an item
// and kPer items a thread.  read() issues every load of the thread
// before put_split() writes them, so a tile can be fetched while the
// previous one is being used.  row(r) gives the start of row r, or
// nullptr for a row of zeros; columns from ncols on read as zero.
template <typename T, int ROWS, int COLS>
struct Tile {
  using Raw = typename Raw4<T>::type;
  static constexpr int kItems = COLS / 4;
  static constexpr int kPer = ROWS * kItems / kThreads;
  static_assert(kPer * kThreads == ROWS * kItems, "tile / threads");
  Raw v[kPer];
  template <typename F>
  __device__ __forceinline__ void read(F row, int ncols, bool vec) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const T* p = row(e / kItems);
      v[k] = p != nullptr ? load_raw(p, 4 * (e % kItems), ncols, vec)
                          : Raw{};
    }
  }
  // the tile's TF32 halves into hi / lo at row stride LD (a multiple of
  // 4), each value times scale(row); lo only where the values are not
  // exact
  template <bool kExact, int LD, typename F>
  __device__ __forceinline__ void put_split(uint32_t* hi, uint32_t* lo,
                                            F scale) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int r = e / kItems, c = 4 * (e % kItems);
      const float s = scale(r);
      const float4 f = widen(v[k]);
      uint4 h, l;
      split<kExact>(f.x * s, h.x, l.x);
      split<kExact>(f.y * s, h.y, l.y);
      split<kExact>(f.z * s, h.z, l.z);
      split<kExact>(f.w * s, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + r * LD + c) = h;
      if (!kExact) *reinterpret_cast<uint4*>(lo + r * LD + c) = l;
    }
  }
  template <bool kExact, int LD>
  __device__ __forceinline__ void put_split(uint32_t* hi,
                                            uint32_t* lo) const {
    put_split<kExact, LD>(hi, lo, [](int) { return 1.f; });
  }
};

// The sum over lanes that differ in the bits of mask's span, the same
// bits in every lane (a fixed tree; float addition commutes).
__device__ __forceinline__ float lanes_sum(float v, int lo_bit, int hi_bit) {
  for (int m = lo_bit; m <= hi_bit; m <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// ---- pass 1 ----------------------------------------------------------------

// Per (chunk, head, batch): local = (exp(cs) dy)^T C into dstates (P x N),
// as ssd_scan.cu's chunk_state: warp w computes rows 16 (w % 4) .. of P
// and columns 64 (w / 4) .. of N over 32-step tiles, the next tile's
// loads in flight during the products.  exp(cs) dy is split into its
// TF32 halves as it is staged, C too unless exact.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_local(const T* __restrict__ dy, const T* __restrict__ Cm,
          const float* __restrict__ dacs, float* __restrict__ dstates,
          Dims d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  uint32_t* s_ah = reinterpret_cast<uint32_t*>(smem);  // kT x kLdP8 each
  uint32_t* s_al = s_ah + kT * kLdP8;
  uint32_t* s_ch = s_al + kT * kLdP8;                  // kT x kLdN8 each
  uint32_t* s_cl = s_ch + kT * kLdN8;
  float* s_e = reinterpret_cast<float*>(s_cl + (kBf16 ? 0 : kT * kLdN8));
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = (long long)b * d.H + h;
  const long long cq = (long long)c * d.Q;
  const long long dy_ss = (long long)d.H * d.P;
  const T* dyh = dy + (long long)b * d.S * dy_ss + (long long)h * d.P;
  const T* cg = Cm + b * d.c_sb + (long long)(h / d.rep) * d.N;

  Tile<T, kT, kMaxP> dyt;
  Tile<T, kT, kMaxN> ct;
  auto fetch = [&](int q0) {
    dyt.read([&](int r) -> const T* {
      const long long s = cq + q0 + r;
      return q0 + r < d.Q && s < d.S ? dyh + s * dy_ss : nullptr;
    }, d.P, d.vec_dy);
    ct.read([&](int r) -> const T* {
      const long long s = cq + q0 + r;
      return q0 + r < d.Q && s < d.S ? cg + s * d.c_ss : nullptr;
    }, d.N, d.vec_c);
  };
  fetch(0);
  const float* cs = dacs + (bh * d.nc + c) * d.Q;
  for (int q = tid; q < d.Q; q += kThreads) s_e[q] = expf(cs[q]);

  const int m0 = 16 * (warp % 4), n0 = 64 * (warp / 4);
  const bool busy = m0 < d.P && n0 < d.N;     // the same for the warp
  float acc[8][4];
  zero(acc);
  for (int q0 = 0; q0 < d.Q; q0 += kT) {
    __syncthreads();              // s_e written / previous tile consumed
    dyt.template put_split<false, kLdP8>(s_ah, s_al, [&](int r) {
      return q0 + r < d.Q ? s_e[q0 + r] : 0.f;
    });
    ct.template put_split<kBf16, kLdN8>(s_ch, s_cl);
    __syncthreads();
    if (q0 + kT < d.Q) fetch(q0 + kT);
    if (busy) {
      warp_mma<8, false, kBf16>(
          acc, 0, (min(kT, d.Q - q0) + 7) / 8,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            hi = s_ah[k * kLdP8 + m0 + r];
            lo = s_al[k * kLdP8 + m0 + r];
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_ch[k * kLdN8 + n0 + col];
            lo = kBf16 ? 0u : s_cl[k * kLdN8 + n0 + col];
          });
    }
  }
  if (!busy) return;
  float* out = dstates + (bh * d.nc + c) * d.P * d.N;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = m0 + gq + (k / 2) * 8;
      const int n = n0 + nt * 8 + 2 * tq + k % 2;
      if (p < d.P && n < d.N) out[p * d.N + n] = acc[nt][k];
    }
  }
}

// ---- pass 2 ----------------------------------------------------------------

// Per state element, backwards over the chunks: chunk c's local sum is
// replaced by ds = dS_{c+1}, then ds <- ds exp(tot_c) + local_c.  The
// loads of kChain chunks are issued before their dependent updates.
// Each block also writes, per chunk, the sum of ds * S_{c+1} over its 256
// elements (a fixed tree: lanes, then warps in order); bwd_finish adds
// the blocks' sums in order.
__global__ void __launch_bounds__(kThreads)
bwd_state(const float* __restrict__ dacs, const float* __restrict__ states,
          const float* __restrict__ final_state,
          const float* __restrict__ dfinal, float* __restrict__ dstates,
          float* __restrict__ dinit, float* __restrict__ dtot_part, Dims d) {
  __shared__ float red[kWarps][kChain];
  const int pn = d.P * d.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.x * kThreads + tid;
  const bool on = e < pn;
  const long long bh = (long long)blockIdx.z * d.H + blockIdx.y;
  float ds = on && dfinal != nullptr ? dfinal[bh * pn + e] : 0.f;
  for (int c1 = d.nc - 1; c1 >= 0; c1 -= kChain) {   // chunks c1, c1 - 1, ..
    float loc[kChain], nxt[kChain], tot[kChain], prod[kChain];
#pragma unroll
    for (int k = 0; k < kChain; ++k) {
      const int c = c1 - k;
      loc[k] = nxt[k] = tot[k] = 0.f;
      if (c < 0) continue;
      const long long at = (bh * d.nc + c) * pn + e;
      if (on) {
        loc[k] = dstates[at];
        nxt[k] = c + 1 < d.nc ? states[at + pn] : final_state[bh * pn + e];
      }
      tot[k] = dacs[(bh * d.nc + c) * d.Q + d.Q - 1];
    }
#pragma unroll
    for (int k = 0; k < kChain; ++k) {
      const int c = c1 - k;
      prod[k] = 0.f;
      if (c < 0) continue;
      if (on) dstates[(bh * d.nc + c) * pn + e] = ds;
      prod[k] = ds * nxt[k];
      ds = ds * expf(tot[k]) + loc[k];
    }
#pragma unroll
    for (int k = 0; k < kChain; ++k) prod[k] = lanes_sum(prod[k], 1, 16);
    __syncthreads();                   // the previous chunks' sums read
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kChain; ++k) red[warp][k] = prod[k];
    }
    __syncthreads();
    if (tid < kChain && c1 - tid >= 0) {
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += red[w][tid];
      dtot_part[(bh * d.nblk + blockIdx.x) * d.nc + c1 - tid] = acc;
    }
  }
  if (on) dinit[bh * pn + e] = ds;
}

// ---- pass 3: the triangle --------------------------------------------------

// Blocks an SM of bwd_cols / bwd_rows: two in bf16 (about 100 KB of
// shared memory each, at most 128 registers a thread); one in f32, whose
// operands' low halves take ~160 KB, with registers to spare.
template <typename T>
constexpr int kMinBlocks = std::is_same<T, __nv_bfloat16>::value ? 2 : 1;

// Rows ph .. ph + 31 of a (P, N) state into its TF32 halves at row stride
// LD, 16 rows a pass (fewer registers in flight beside the accumulators).
template <int LD>
__device__ __forceinline__ void stage_state(uint32_t* hi, uint32_t* lo,
                                            const float* st, int ph,
                                            const Dims& d) {
#pragma unroll 1
  for (int r0 = 0; r0 < kT; r0 += 16) {
    Tile<float, 16, kMaxN> t;
    t.read([&](int r) -> const float* {
      const int p = ph + r0 + r;
      return p < d.P ? st + p * d.N : nullptr;
    }, d.N, d.vec_st);
    t.put_split<false, LD>(hi + r0 * LD, lo + r0 * LD);
  }
}

// The block's place in the grid (chunk, batch, head block; strip) and the
// warp's place in a tile: rows 16 (w % 2) .. of every 32-row product, and
// of its columns 8 (w / 2) .. of a score tile, 16 (w / 2) .. of P and
// 32 (w / 2) .. of N.
struct Place {
  int c, b, hb, h0, g, strip, wm, wc, gq, tq;
  long long cq;
  __device__ Place(const Dims& d, int strip_) {
    c = blockIdx.x % d.nc;
    const int rest = blockIdx.x / d.nc;
    hb = rest % d.nhb;
    b = rest / d.nhb;
    h0 = hb * d.hblk;
    g = h0 / d.rep;
    strip = strip_;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm = 16 * (warp % 2);
    wc = warp / 2;
    gq = lane / 4;
    tq = lane % 4;
    cq = (long long)c * d.Q;
  }
  // the fragment's row (k = 0..3 of a c fragment) and score column
  __device__ int row(int k) const { return wm + gq + (k / 2) * 8; }
  __device__ int col(int k) const { return 8 * wc + 2 * tq + k % 2; }
};

// cs and dt of head h over steps [0, n) of the chunk into s_cs, s_dt
__device__ __forceinline__ void load_chunk(float* s_cs, float* s_dt,
                                           const float* dacs,
                                           const float* dt, const Place& pl,
                                           int h, int n, const Dims& d) {
  const long long bh = (long long)pl.b * d.H + h;
  const float* cs = dacs + (bh * d.nc + pl.c) * d.Q;
  const float* dth = dt + pl.b * d.dt_sb + h;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const long long s = pl.cq + q;
    s_cs[q] = cs[q];
    s_dt[q] = s < d.S ? dth[s * d.dt_ss] : 0.f;
  }
}

// Shared memory of bwd_cols in words: x_J (hi, lo), B_J (hi, lo), then
// the tile region (C_I, dy_I, t1, t2; the halves of dS_next reuse it),
// the kept C.B^T, cs, dt and the cross-warp partial sums.  An exact
// (bf16) operand keeps no lo.
template <bool kExact>
struct ColsSmem {
  static constexpr int kLo = kExact ? 0 : 1;
  static constexpr int kX = kT * kLdP4;
  static constexpr int kB = kT * kLdN4;
  static constexpr int kC = kT * kLdN8;
  static constexpr int kDy = kT * kLdP4;
  static constexpr int kTT = kT * kLdT8;
  static constexpr int kTiles = (1 + kLo) * (kC + kDy) + 4 * kTT;
  static constexpr int kState = 2 * kT * kLdN4;
  static constexpr int kRegion = kTiles > kState ? kTiles : kState;
  static constexpr int kCb = kSpanTiles * 4 * kThreads;
  static constexpr int kRed = 10 * kT;
  static constexpr size_t bytes(int Q) {
    return 4 * (size_t)((1 + kLo) * (kX + kB) + kRegion + kCb + 2 * Q +
                        kRed);
  }
};

// One 32-step strip of source steps j of one chunk for hblk heads of one
// group.  Per head, per row tile i0 >= j0: C.B^T (the first head; kept
// per thread), dy.x^T, t1 and t2 masked before the exp and split into
// shared memory, then dx += t1^T dy and dB += t2^T C; then the state
// terms (dS_next in two halves of P); the next head's first tile is
// fetched after them, beside the head's sums and writes.  Its accumulators
// (dB, dx) leave little of bf16's 128-register cap, so it runs its
// products one k-step at a time and reads each row tile's C rows at the
// tile's start, not in flight beside dy's: otherwise it spills (and one
// block an SM is spill-free but slower on an H100).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
bwd_cols(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ Bm, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ dacs,
         const float* __restrict__ dstates, T* __restrict__ dx,
         float* __restrict__ dBs, float* __restrict__ ddt_dir,
         float* __restrict__ dcs_col, Dims d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using L = ColsSmem<kBf16>;
  extern __shared__ __align__(16) float smem[];
  uint32_t* s_xh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_xl = s_xh + L::kLo * L::kX;
  uint32_t* s_bh = s_xh + (1 + L::kLo) * L::kX;
  uint32_t* s_bl = s_bh + L::kLo * L::kB;
  uint32_t* s_ch = s_bh + (1 + L::kLo) * L::kB;   // the tile region
  uint32_t* s_cl = s_ch + L::kLo * L::kC;
  uint32_t* s_dyh = s_ch + (1 + L::kLo) * L::kC;
  uint32_t* s_dyl = s_dyh + L::kLo * L::kDy;
  uint32_t* s_t1h = s_dyh + (1 + L::kLo) * L::kDy;
  uint32_t* s_t1l = s_t1h + L::kTT;
  uint32_t* s_t2h = s_t1l + L::kTT;
  uint32_t* s_t2l = s_t2h + L::kTT;
  uint32_t* s_sh = s_ch;                          // half of dS_next
  uint32_t* s_sl = s_sh + kT * kLdN4;
  float* s_cb = reinterpret_cast<float*>(s_ch + L::kRegion);
  float* s_cs = s_cb + L::kCb;
  float* s_dt = s_cs + d.Q;
  float* s_red = s_dt + d.Q;

  const Place pl(d, blockIdx.y);                  // strip 0 (longest) first
  const int tid = threadIdx.x;
  const int j0 = pl.strip * kT;
  const int nI = (d.Q - j0 + kT - 1) / kT;        // row tiles i0 = j0 + kT it
  const bool cached = d.Q - j0 <= kSpan;
  const int ksn = (d.N + 7) / 8, ksp = (d.P + 7) / 8;
  const long long dy_ss = (long long)d.H * d.P;
  const T* bg = Bm + pl.b * d.b_sb + (long long)pl.g * d.N;
  const T* cg = Cm + pl.b * d.c_sb + (long long)pl.g * d.N;
  auto in_chunk = [&](int q) { return q < d.Q && pl.cq + q < d.S; };

  {                                               // B_J, once
    Tile<T, kT, kMaxN> bt;
    bt.read([&](int r) -> const T* {
      return in_chunk(j0 + r) ? bg + (pl.cq + j0 + r) * d.b_ss : nullptr;
    }, d.N, d.vec_b);
    bt.template put_split<kBf16, kLdN4>(s_bh, s_bl);
  }
  Tile<T, kT, kMaxP> dyt;                         // the next tile's loads
  Tile<T, kT, kMaxN> ct;                          // read at the tile's start
  auto fetch_dy = [&](int h, int it) {
    const int i0 = j0 + it * kT;
    const T* dyh = dy + (long long)pl.b * d.S * dy_ss + (long long)h * d.P;
    dyt.read([&](int r) -> const T* {
      return in_chunk(i0 + r) ? dyh + (pl.cq + i0 + r) * dy_ss : nullptr;
    }, d.P, d.vec_dy);
  };
  auto fetch_c = [&](int it) {
    const int i0 = j0 + it * kT;
    ct.read([&](int r) -> const T* {
      return in_chunk(i0 + r) ? cg + (pl.cq + i0 + r) * d.c_ss : nullptr;
    }, d.N, d.vec_c);
  };

  float dB[4][4];                                 // the block's dB_J
  zero(dB);
  for (int hh = 0; hh < d.hblk; ++hh) {
    const int h = pl.h0 + hh;
    const long long bh = (long long)pl.b * d.H + h;
    const T* xh = x + pl.b * d.x_sb + (long long)h * d.P;
    __syncthreads();                  // the previous head's tiles consumed
    load_chunk(s_cs, s_dt, dacs, dt, pl, h, d.Q, d);
    {
      Tile<T, kT, kMaxP> xt;
      xt.read([&](int r) -> const T* {
        return in_chunk(j0 + r) ? xh + (pl.cq + j0 + r) * d.x_ss : nullptr;
      }, d.P, d.vec_x);
      xt.template put_split<kBf16, kLdP4>(s_xh, s_xl);
    }
    if (hh == 0) fetch_dy(h, 0);

    float dxa[2][4], col_e[2] = {0.f, 0.f};
    zero(dxa);
    for (int it = 0; it < nI; ++it) {
      const int i0 = j0 + it * kT;
      __syncthreads();                // the region consumed
      fetch_c(it);
      dyt.template put_split<kBf16, kLdP4>(s_dyh, s_dyl);
      ct.template put_split<kBf16, kLdN8>(s_ch, s_cl);
      __syncthreads();
      // C.B^T of this tile, formed at the first head and kept by the
      // thread that holds it, and dy.x^T
      float cb[4], sc[1][4];
      float* kept = s_cb + it * 4 * kThreads + tid;
      if (!cached || hh == 0) {
        float a[1][4];
        zero(a);
        warp_mma<1, kBf16, kBf16, true>(
            a, 0, ksn,
            [&](int r, int k, uint32_t& hi, uint32_t& lo) {
              hi = s_ch[(pl.wm + r) * kLdN8 + k];
              lo = kBf16 ? 0u : s_cl[(pl.wm + r) * kLdN8 + k];
            },
            [&](int k, int col, uint32_t& hi, uint32_t& lo) {
              hi = s_bh[(8 * pl.wc + col) * kLdN4 + k];
              lo = kBf16 ? 0u : s_bl[(8 * pl.wc + col) * kLdN4 + k];
            });
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cb[k] = a[0][k];
          if (cached) kept[k * kThreads] = cb[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) cb[k] = kept[k * kThreads];
      }
      zero(sc);
      warp_mma<1, kBf16, kBf16, true>(
          sc, 0, ksp,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            hi = s_dyh[(pl.wm + r) * kLdP4 + k];
            lo = kBf16 ? 0u : s_dyl[(pl.wm + r) * kLdP4 + k];
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_xh[(8 * pl.wc + col) * kLdP4 + k];
            lo = kBf16 ? 0u : s_xl[(8 * pl.wc + col) * kLdP4 + k];
          });
      // t1 and t2, masked to j <= i before the exp
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int il = pl.row(k), jl = pl.col(k);
        const int i = i0 + il, j = j0 + jl;
        float t1 = 0.f, t2 = 0.f;
        if (i < d.Q && j <= i) {
          const float l = expf(s_cs[i] - s_cs[j]);
          t1 = cb[k] * l;
          t2 = sc[0][k] * l * s_dt[j];
          col_e[k % 2] += t2 * cb[k];
        }
        split<false>(t1, s_t1h[il * kLdT8 + jl], s_t1l[il * kLdT8 + jl]);
        split<false>(t2, s_t2h[il * kLdT8 + jl], s_t2l[il * kLdT8 + jl]);
      }
      if (it + 1 < nI) fetch_dy(h, it + 1);   // flies during the products
      __syncthreads();
      // dx_J += t1^T dy_I (32 x P), dB_J += t2^T C_I (32 x N), over the
      // tile's rows i
      // (on the diagonal tile t1 and t2 vanish for i < j: the products
      // over i start at the warp's first row j)
      const int ks0 = it == 0 ? pl.wm / 8 : 0;
      const int ksi = (min(kT, d.Q - i0) + 7) / 8;
      auto prod_dx = [&] {
        warp_mma<2, false, kBf16, true>(
            dxa, ks0, ksi,
            [&](int r, int k, uint32_t& hi, uint32_t& lo) {
              hi = s_t1h[k * kLdT8 + pl.wm + r];
              lo = s_t1l[k * kLdT8 + pl.wm + r];
            },
            [&](int k, int col, uint32_t& hi, uint32_t& lo) {
              hi = s_dyh[k * kLdP4 + 16 * pl.wc + col];
              lo = kBf16 ? 0u : s_dyl[k * kLdP4 + 16 * pl.wc + col];
            });
      };
      auto prod_db = [&] {
        warp_mma<4, false, kBf16, true>(
            dB, ks0, ksi,
            [&](int r, int k, uint32_t& hi, uint32_t& lo) {
              hi = s_t2h[k * kLdT8 + pl.wm + r];
              lo = s_t2l[k * kLdT8 + pl.wm + r];
            },
            [&](int k, int col, uint32_t& hi, uint32_t& lo) {
              hi = s_ch[k * kLdN8 + 32 * pl.wc + col];
              lo = kBf16 ? 0u : s_cl[k * kLdN8 + 32 * pl.wc + col];
            });
      };
      prod_dx();
      prod_db();
    }

    // x_jp exactly (bf16 values are their own TF32 hi), 0 outside
    auto x_at = [&](int k, int p) {
      const int j = j0 + pl.row(k);
      if (!in_chunk(j) || p >= d.P) return 0.f;
      return kBf16 ? __uint_as_float(s_xh[pl.row(k) * kLdP4 + p])
                   : ld(xh + (pl.cq + j) * d.x_ss + p);
    };
    // the state terms: v = B_J dS^T (32 x P), folded into dxa as
    // exp(tot - cs_j) v with the sums over P of x.v (d cs) as soon as
    // the warp's half of P is done; u = x_J dS (32 x N), over both
    const float tot = s_cs[d.Q - 1];
    float u[4][4], pv[2] = {0.f, 0.f};
    zero(u);
    const float* dS = dstates + (bh * d.nc + pl.c) * d.P * d.N;
    for (int ph = 0; ph < d.P; ph += kT) {
      __syncthreads();                // the tiles / previous half consumed
      stage_state<kLdN4>(s_sh, s_sl, dS, ph, d);
      __syncthreads();
      const int pc = 16 * pl.wc - ph;             // the warp's columns of P
      if (pc >= 0 && pc < kT) {
        float v[2][4];
        zero(v);
        warp_mma<2, kBf16, false, true>(
            v, 0, ksn,
            [&](int r, int k, uint32_t& hi, uint32_t& lo) {
              hi = s_bh[(pl.wm + r) * kLdN4 + k];
              lo = kBf16 ? 0u : s_bl[(pl.wm + r) * kLdN4 + k];
            },
            [&](int k, int col, uint32_t& hi, uint32_t& lo) {
              hi = s_sh[(pc + col) * kLdN4 + k];
              lo = s_sl[(pc + col) * kLdN4 + k];
            });
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + pl.row(k);
          const float decay = j < d.Q ? expf(tot - s_cs[j]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int p = 16 * pl.wc + nt * 8 + 2 * pl.tq + k % 2;
            pv[k / 2] += x_at(k, p) * v[nt][k];
            dxa[nt][k] += decay * v[nt][k];
          }
        }
      }
      warp_mma<4, kBf16, false, true>(
          u, 0, (min(kT, d.P - ph) + 7) / 8,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            hi = s_xh[(pl.wm + r) * kLdP4 + ph + k];
            lo = kBf16 ? 0u : s_xl[(pl.wm + r) * kLdP4 + ph + k];
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_sh[k * kLdN4 + 32 * pl.wc + col];
            lo = s_sl[k * kLdN4 + 32 * pl.wc + col];
          });
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + pl.row(k);
      const float w = j < d.Q ? expf(tot - s_cs[j]) * s_dt[j] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dB[nt][k] += w * u[nt][k];
    }
    if (hh + 1 < d.hblk) fetch_dy(h + 1, 0);   // flies during what follows

    // dx_J = dt_j dxa; per j the sum over P of x.dx/dt (ddt's direct
    // term)
    T* dxh = dx + (long long)pl.b * d.S * dy_ss + (long long)h * d.P;
    float pd[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + pl.row(k);
      const float dtj = j < d.Q ? s_dt[j] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int p = 16 * pl.wc + nt * 8 + 2 * pl.tq + k % 2;
        pd[k / 2] += x_at(k, p) * dxa[nt][k];
        if (in_chunk(j) && p < d.P)
          st(dxh + (pl.cq + j) * dy_ss + p, dtj * dxa[nt][k]);
      }
    }
    float* r_dd = s_red;              // [wc][j]
    float* r_xv = r_dd + 4 * kT;      // [wc][j]
    float* r_e = r_xv + 4 * kT;       // [warp % 2][j]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pd[r] = lanes_sum(pd[r], 1, 2);
      pv[r] = lanes_sum(pv[r], 1, 2);
      col_e[r] = lanes_sum(col_e[r], 4, 16);
    }
    if (pl.tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        r_dd[pl.wc * kT + pl.wm + pl.gq + 8 * r] = pd[r];
        r_xv[pl.wc * kT + pl.wm + pl.gq + 8 * r] = pv[r];
      }
    }
    if (pl.gq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        r_e[(pl.wm / 16) * kT + 8 * pl.wc + 2 * pl.tq + r] = col_e[r];
    }
    __syncthreads();
    if (tid < kT && in_chunk(j0 + tid)) {
      const int j = j0 + tid;
      float sdd = 0.f, sxv = 0.f;
      for (int k = 0; k < 4; ++k) {
        sdd += r_dd[k * kT + tid];
        sxv += r_xv[k * kT + tid];
      }
      const float se = r_e[tid] + r_e[kT + tid];
      const float w = expf(tot - s_cs[j]) * s_dt[j];
      const long long at = (bh * d.nc + pl.c) * d.Q + j;
      ddt_dir[at] = sdd;
      dcs_col[at] = -se - w * sxv;
    }
  }

  // the block's share of dB, (B, S, nhb, N)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + pl.row(k);
    if (!in_chunk(j)) continue;
    float* row = dBs + (((long long)pl.b * d.S + pl.cq + j) * d.nhb + pl.hb) *
                           d.N;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 32 * pl.wc + nt * 8 + 2 * pl.tq + k % 2;
      if (n < d.N) row[n] = dB[nt][k];
    }
  }
}

// Shared memory of bwd_rows in words: dy_I (hi, lo), C_I (hi, lo), then
// the tile region (x_J, B_J, t2; the halves of S reuse it), the kept
// C.B^T, cs, dt and the cross-warp partial sums.
template <bool kExact>
struct RowsSmem {
  static constexpr int kLo = kExact ? 0 : 1;
  static constexpr int kDy = kT * kLdP4;
  static constexpr int kC = kT * kLdN4;
  static constexpr int kX = kT * kLdP4;
  static constexpr int kB = kT * kLdN8;
  static constexpr int kTT = kT * kLdT4;
  static constexpr int kTiles = (1 + kLo) * (kX + kB) + 2 * kTT;
  static constexpr int kState = 2 * kT * kLdN8;
  static constexpr int kRegion = kTiles > kState ? kTiles : kState;
  static constexpr int kCb = kSpanTiles * 4 * kThreads;
  static constexpr int kRed = 8 * kT;
  static constexpr size_t bytes(int Q) {
    return 4 * (size_t)((1 + kLo) * (kDy + kC) + kRegion + kCb + 2 * Q +
                        kRed);
  }
};

// One 32-step strip of rows i of one chunk for hblk heads of one group.
// Per head, per source tile j0 <= i0: C.B^T (the first head; kept per
// thread), dy.x^T, t2 masked before the exp and split into shared
// memory, then dC += t2 B; then the state term exp(cs_i) S^T dy_i (S in
// two halves of P); the next head's first tile is fetched after it.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
bwd_rows(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ Bm, const T* __restrict__ Cm,
         const T* __restrict__ dy, const float* __restrict__ dacs,
         const float* __restrict__ states, float* __restrict__ dCs,
         float* __restrict__ dcs_row, Dims d) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using L = RowsSmem<kBf16>;
  extern __shared__ __align__(16) float smem[];
  uint32_t* s_dyh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_dyl = s_dyh + L::kLo * L::kDy;
  uint32_t* s_ch = s_dyh + (1 + L::kLo) * L::kDy;
  uint32_t* s_cl = s_ch + L::kLo * L::kC;
  uint32_t* s_xh = s_ch + (1 + L::kLo) * L::kC;   // the tile region
  uint32_t* s_xl = s_xh + L::kLo * L::kX;
  uint32_t* s_bh = s_xh + (1 + L::kLo) * L::kX;
  uint32_t* s_bl = s_bh + L::kLo * L::kB;
  uint32_t* s_t2h = s_bh + (1 + L::kLo) * L::kB;
  uint32_t* s_t2l = s_t2h + L::kTT;
  uint32_t* s_sh = s_xh;                          // half of S
  uint32_t* s_sl = s_sh + kT * kLdN8;
  float* s_cb = reinterpret_cast<float*>(s_xh + L::kRegion);
  float* s_cs = s_cb + L::kCb;
  float* s_dt = s_cs + d.Q;
  float* s_red = s_dt + d.Q;

  const Place pl(d, gridDim.y - 1 - blockIdx.y);  // the longest strips first
  const int tid = threadIdx.x;
  const int i0 = pl.strip * kT;
  const int i_end = min(i0 + kT, d.Q);
  const int nJ = pl.strip + 1;                    // source tiles j0 <= i0
  const bool cached = i_end <= kSpan;
  const int ksn = (d.N + 7) / 8, ksp = (d.P + 7) / 8;
  const long long dy_ss = (long long)d.H * d.P;
  const T* bg = Bm + pl.b * d.b_sb + (long long)pl.g * d.N;
  const T* cg = Cm + pl.b * d.c_sb + (long long)pl.g * d.N;
  auto in_chunk = [&](int q) { return q < d.Q && pl.cq + q < d.S; };

  {                                               // C_I, once
    Tile<T, kT, kMaxN> ct;
    ct.read([&](int r) -> const T* {
      return in_chunk(i0 + r) ? cg + (pl.cq + i0 + r) * d.c_ss : nullptr;
    }, d.N, d.vec_c);
    ct.template put_split<kBf16, kLdN4>(s_ch, s_cl);
  }
  Tile<T, kT, kMaxP> xt;                          // the next tile's loads
  Tile<T, kT, kMaxN> bt;
  auto fetch = [&](int h, int jt) {
    const int j0 = jt * kT;
    const T* xh = x + pl.b * d.x_sb + (long long)h * d.P;
    xt.read([&](int r) -> const T* {
      return in_chunk(j0 + r) ? xh + (pl.cq + j0 + r) * d.x_ss : nullptr;
    }, d.P, d.vec_x);
    bt.read([&](int r) -> const T* {
      return in_chunk(j0 + r) ? bg + (pl.cq + j0 + r) * d.b_ss : nullptr;
    }, d.N, d.vec_b);
  };

  float dC[4][4];                                 // the block's dC_I
  zero(dC);
  for (int hh = 0; hh < d.hblk; ++hh) {
    const int h = pl.h0 + hh;
    const long long bh = (long long)pl.b * d.H + h;
    __syncthreads();                  // the previous head's tiles consumed
    load_chunk(s_cs, s_dt, dacs, dt, pl, h, i_end, d);
    {
      const T* dyh = dy + (long long)pl.b * d.S * dy_ss + (long long)h * d.P;
      Tile<T, kT, kMaxP> dyt;
      dyt.read([&](int r) -> const T* {
        return in_chunk(i0 + r) ? dyh + (pl.cq + i0 + r) * dy_ss : nullptr;
      }, d.P, d.vec_dy);
      dyt.template put_split<kBf16, kLdP4>(s_dyh, s_dyl);
    }
    if (hh == 0) fetch(h, 0);

    float row_e[2] = {0.f, 0.f};
    for (int jt = 0; jt < nJ; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();                // the region consumed
      xt.template put_split<kBf16, kLdP4>(s_xh, s_xl);
      bt.template put_split<kBf16, kLdN8>(s_bh, s_bl);
      __syncthreads();
      if (jt + 1 < nJ) fetch(h, jt + 1);
      float cb[4], sc[1][4];
      float* kept = s_cb + jt * 4 * kThreads + tid;
      if (!cached || hh == 0) {
        float a[1][4];
        zero(a);
        warp_mma<1, kBf16, kBf16>(
            a, 0, ksn,
            [&](int r, int k, uint32_t& hi, uint32_t& lo) {
              hi = s_ch[(pl.wm + r) * kLdN4 + k];
              lo = kBf16 ? 0u : s_cl[(pl.wm + r) * kLdN4 + k];
            },
            [&](int k, int col, uint32_t& hi, uint32_t& lo) {
              hi = s_bh[(8 * pl.wc + col) * kLdN8 + k];
              lo = kBf16 ? 0u : s_bl[(8 * pl.wc + col) * kLdN8 + k];
            });
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cb[k] = a[0][k];
          if (cached) kept[k * kThreads] = cb[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) cb[k] = kept[k * kThreads];
      }
      zero(sc);
      warp_mma<1, kBf16, kBf16>(
          sc, 0, ksp,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            hi = s_dyh[(pl.wm + r) * kLdP4 + k];
            lo = kBf16 ? 0u : s_dyl[(pl.wm + r) * kLdP4 + k];
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_xh[(8 * pl.wc + col) * kLdP4 + k];
            lo = kBf16 ? 0u : s_xl[(8 * pl.wc + col) * kLdP4 + k];
          });
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int il = pl.row(k), jl = pl.col(k);
        const int i = i0 + il, j = j0 + jl;
        float t2 = 0.f;
        if (i < d.Q && j <= i) {
          t2 = sc[0][k] * expf(s_cs[i] - s_cs[j]) * s_dt[j];
          row_e[k / 2] += t2 * cb[k];
        }
        split<false>(t2, s_t2h[il * kLdT4 + jl], s_t2l[il * kLdT4 + jl]);
      }
      __syncthreads();
      // dC_I += t2 B_J (32 x N), over the tile's sources j (on the
      // diagonal tile t2 vanishes past the warp's last row i)
      const int kend = j0 == i0 ? min(kT, pl.wm + 16) : kT;
      warp_mma<4, false, kBf16>(
          dC, 0, (min(kend, i_end - j0) + 7) / 8,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            hi = s_t2h[(pl.wm + r) * kLdT4 + k];
            lo = s_t2l[(pl.wm + r) * kLdT4 + k];
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_bh[k * kLdN8 + 32 * pl.wc + col];
            lo = kBf16 ? 0u : s_bl[k * kLdN8 + 32 * pl.wc + col];
          });
    }

    // the inter-chunk term: ci = S^T dy_I (32 x N), then exp(cs_i) ci
    float ci[4][4];
    zero(ci);
    const float* S0 = states + (bh * d.nc + pl.c) * d.P * d.N;
    for (int ph = 0; ph < d.P; ph += kT) {
      __syncthreads();                // the tiles / previous half consumed
      stage_state<kLdN8>(s_sh, s_sl, S0, ph, d);
      __syncthreads();
      warp_mma<4, kBf16, false>(
          ci, 0, (min(kT, d.P - ph) + 7) / 8,
          [&](int r, int k, uint32_t& hi, uint32_t& lo) {
            hi = s_dyh[(pl.wm + r) * kLdP4 + ph + k];
            lo = kBf16 ? 0u : s_dyl[(pl.wm + r) * kLdP4 + ph + k];
          },
          [&](int k, int col, uint32_t& hi, uint32_t& lo) {
            hi = s_sh[k * kLdN8 + 32 * pl.wc + col];
            lo = s_sl[k * kLdN8 + 32 * pl.wc + col];
          });
    }
    float pc[2] = {0.f, 0.f};         // per row, C_i . (exp(cs_i) ci)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + pl.row(k);
      const bool on = in_chunk(i);
      const float e = i < d.Q ? expf(s_cs[i]) : 0.f;
      const T* crow = cg + (pl.cq + i) * d.c_ss;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = 32 * pl.wc + nt * 8 + 2 * pl.tq + k % 2;
        const float val = e * ci[nt][k];
        const float cv =                // C exactly, as x in bwd_cols
            !(on && n < d.N) ? 0.f
            : kBf16 ? __uint_as_float(s_ch[pl.row(k) * kLdN4 + n])
                    : ld(crow + n);
        pc[k / 2] += cv * val;
        dC[nt][k] += val;
      }
    }
    if (hh + 1 < d.hblk) fetch(h + 1, 0);   // flies during what follows


    // per row: sum_j E_ij + C_i . (exp(cs_i) S^T dy_i)
    float* r_e = s_red;               // [wc][i]
    float* r_c = r_e + 4 * kT;        // [wc][i]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_e[r] = lanes_sum(row_e[r], 1, 2);
      pc[r] = lanes_sum(pc[r], 1, 2);
    }
    if (pl.tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        r_e[pl.wc * kT + pl.wm + pl.gq + 8 * r] = row_e[r];
        r_c[pl.wc * kT + pl.wm + pl.gq + 8 * r] = pc[r];
      }
    }
    __syncthreads();
    if (tid < kT && in_chunk(i0 + tid)) {
      float se = 0.f, sc = 0.f;
      for (int k = 0; k < 4; ++k) {
        se += r_e[k * kT + tid];
        sc += r_c[k * kT + tid];
      }
      dcs_row[(bh * d.nc + pl.c) * d.Q + i0 + tid] = se + sc;
    }
  }

  // the block's share of dC, (B, S, nhb, N)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + pl.row(k);
    if (!in_chunk(i)) continue;
    float* row = dCs + (((long long)pl.b * d.S + pl.cq + i) * d.nhb + pl.hb) *
                           d.N;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 32 * pl.wc + nt * 8 + 2 * pl.tq + k % 2;
      if (n < d.N) row[n] = dC[nt][k];
    }
  }
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

// dB (blockIdx.y 0) and dC (1): the head blocks' shares of each group
// summed in order, into (B, S, G, N) of x's type.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_bc(const float* __restrict__ dBs, const float* __restrict__ dCs,
              T* __restrict__ dB, T* __restrict__ dC, Dims d) {
  const long long total = (long long)d.B * d.S * d.G * d.N;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const float* src = blockIdx.y == 0 ? dBs : dCs;
  T* dst = blockIdx.y == 0 ? dB : dC;
  const int n = (int)(e % d.N);
  const long long sg = e / d.N;        // (b * S + s) * G + g
  const int g = (int)(sg % d.G);
  const long long bs = sg / d.G;
  const int per = d.nhb / d.G;         // head blocks a group
  const float* row = src + (bs * d.nhb + (long long)g * per) * d.N + n;
  float acc = 0.f;
  for (int k = 0; k < per; ++k) acc += row[(long long)k * d.N];
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

template <bool kExact>
size_t local_smem(int Q) {
  return 4 * (size_t)(2 * kT * kLdP8 + (kExact ? 1 : 2) * kT * kLdN8 + Q);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const void* dy,
                   const float* dfinal, const float* dacs,
                   const float* states, const float* final_state, void* dx,
                   float* ddt, float* dA, void* dB, void* dC, float* dinit,
                   float* dstates, float* dtot_part, float* rows_cols,
                   float* dbc_shares, float* da_part, const Dims& d,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using LC = ColsSmem<kBf16>;
  using LR = RowsSmem<kBf16>;
  // opt in once to the largest shared memory any chunk length needs (the
  // first call comes before any CUDA graph capture of the launch)
  static cudaError_t attr_err = [] {
    const auto set = [](const void* fn, size_t bytes) {
      return cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    };
    cudaError_t e = set((const void*)bwd_local<T>, local_smem<kBf16>(kMaxQ));
    if (e == cudaSuccess)
      e = set((const void*)bwd_cols<T>, LC::bytes(kMaxQ));
    if (e == cudaSuccess)
      e = set((const void*)bwd_rows<T>, LR::bytes(kMaxQ));
    return e;
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
  float* dBs = dbc_shares;
  float* dCs = dbc_shares + (long long)d.B * d.S * d.nhb * d.N;
  cudaError_t err;

  bwd_local<T><<<dim3(d.nc, d.H, d.B), kThreads, local_smem<kBf16>(d.Q),
                 stream>>>(tdy, tc, dacs, dstates, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_state<<<dim3(d.nblk, d.H, d.B), kThreads, 0, stream>>>(
      dacs, states, final_state, dfinal, dstates, dinit, dtot_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // strips in the slow grid dimension: the blocks that walk the most
  // tiles are dispatched first
  const dim3 strips((unsigned)(d.nc * d.B * d.nhb), (d.Q + kT - 1) / kT);
  bwd_cols<T><<<strips, kThreads, LC::bytes(d.Q), stream>>>(
      tx, dt, tb, tc, tdy, dacs, dstates, static_cast<T*>(dx), dBs, ddt_dir,
      dcs_col, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_rows<T><<<strips, kThreads, LR::bytes(d.Q), stream>>>(
      tx, dt, tb, tc, tdy, dacs, states, dCs, dcs_row, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_finish<<<dim3(d.nc, d.H, d.B), kThreads,
               sizeof(float) * (d.Q + 32), stream>>>(
      dt, A, dcs_row, dcs_col, ddt_dir, dtot_part, ddt, da_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long bc = (long long)d.B * d.S * d.G * d.N;
  bwd_reduce_bc<T><<<dim3((unsigned)((bc + kThreads - 1) / kThreads), 2),
                     kThreads, 0, stream>>>(dBs, dCs, static_cast<T*>(dB),
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
// B*H*nblk*nc (nblk = ceil(P*N / 256)), rows_cols 3*B*H*nc*Q, dbc_shares
// 2*B*S*(H/hblk)*N, da_part B*H*nc.  hblk, the heads a block of the
// triangle covers, divides H/G and is at most 8.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* dacs,
    const void* states, const void* final_state, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, void* dstates,
    void* dtot_part, void* rows_cols, void* dbc_shares, void* da_part, int B,
    int S, int H, int P, int G, int N, int Q, int hblk, long long x_sb,
    long long x_ss, long long dt_sb, long long dt_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || Q <= 0 || Q > kMaxQ || G <= 0 || H % G != 0 ||
      hblk <= 0 || hblk > kMaxHblk || (H / G) % hblk != 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = (S + Q - 1) / Q;
  const int rep = H / G;
  const int nhb = H / hblk;
  if (nc > 65535 || B > 65535 || H > 65535 ||
      (long long)nc * B * nhb > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int nblk = (P * N + kThreads - 1) / kThreads;
  // rows read 4 elements a load where every row start is aligned to them
  const uintptr_t al = dtype == 0 ? 16 : 8;
  auto rows4 = [&](const void* p, long long sb, long long ss, int off) {
    return (int)((uintptr_t)p % al == 0 && sb % 4 == 0 && ss % 4 == 0 &&
                 off % 4 == 0);
  };
  Dims d{B, S, H, P, G, N, Q, nc, rep, nblk, hblk, nhb,
         rows4(x, x_sb, x_ss, P), rows4(Bm, b_sb, b_ss, N),
         rows4(Cm, c_sb, c_ss, N),
         rows4(dy, (long long)S * H * P, (long long)H * P, P),
         (int)(N % 4 == 0 && (uintptr_t)states % 16 == 0 &&
               (uintptr_t)dstates % 16 == 0),
         x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err = dtype == 0
      ? launch<float>(x, f(dt), f(A), Bm, Cm, dy, f(dfinal), f(dacs),
                      f(states), f(final_state), dx, w(ddt), w(dA), dB, dC,
                      w(dinit), w(dstates), w(dtot_part), w(rows_cols),
                      w(dbc_shares), w(da_part), d, s)
      : launch<__nv_bfloat16>(x, f(dt), f(A), Bm, Cm, dy, f(dfinal),
                              f(dacs), f(states), f(final_state), dx, w(ddt),
                              w(dA), dB, dC, w(dinit), w(dstates),
                              w(dtot_part), w(rows_cols), w(dbc_shares),
                              w(da_part), d, s);
  return (int)err;
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
