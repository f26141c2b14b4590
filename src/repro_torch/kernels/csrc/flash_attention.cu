// flash_attention — blocked online-softmax attention for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_kernel, body _kernel).  For q (B, Sq, H, D) and k, v
// (B, Sk, Hkv, D), query head h reading kv head h / (H / Hkv):
//
//   x      = (q . k) / sqrt(D)                accumulated in f32
//   x      = cap * tanh(x / cap)              when a softcap is set
//   mask   = k_pos < Sk, k_pos <= q_pos (causal, top-left aligned: the
//            positions are the implicit aranges), q_pos - k_pos < window
//   running max m, sum l and accumulator acc in f32 over key tiles;
//   p = exp(x - m) is rounded to v's type before p . v (as the TPU kernel
//   does), l sums the unrounded p;
//   out    = acc / max(l, 1e-30) in q's type, so a fully masked row is 0.
//
// The TPU kernel walks the key blocks of one query block in order (the
// sequential grid axis ik) with (m, l, acc) in VMEM scratch.  On the H100
// blocks run in parallel and in no order, so each path below loops over
// key tiles inside a block with m, l and acc in registers.  Four kernels
// sit behind one entry point; the wrapper (kernels/flash_attention.py)
// chooses among them by shape and dtype alone:
//
// 1. flash_decode (f32 or bf16, G * Sq <= 64 rows a kv head): bound by
//    bytes.  A decode step reads the cache slice once and does ~4 flops a
//    byte, so what matters is filling the card's 132 SMs with loads and
//    keeping the arithmetic off the critical path.  One block per (b, kv
//    head, split): the G query heads x Sq rows of a kv head are its rows
//    (up to 4 in one block, else blocks of 16 rows), so k and v are read
//    once per kv head, and the keys are cut into contiguous splits (a
//    pure function of B, Hkv and Sk in the wrapper) so that there are >= 2
//    blocks an SM.  Each block streams its split through a 3-stage
//    cp.async ring of 32-key tiles (16-byte copies, rows padded by 16
//    bytes against bank conflicts); products on the CUDA cores in f32.
//    Each warp takes 8 keys of every tile with its own (m, l, acc), so all
//    four warps work whatever the row count and the softmax is a few
//    shuffles; the warps are merged in warp order at the end.  Each split
//    writes f32 partials (m, l, acc) to scratch from the wrapper, and
//    flash_combine merges them in split order (no atomics: the same bits
//    from call to call).  A split that sees no key leaves m = -1e30,
//    l = 0.
// 2. flash_prefill_wgmma (bf16, D in {64, 128, 256}, more rows): bound by
//    operations (a gemma2-9b prefill layer is ~0.6 TFLOP over ~0.2 GB).
//    See its section below.
// 3. flash_bf16 (bf16, other D): mma.sync m16n8k16, 64 query rows a
//    block, k and v tiles staged by cp.async.
// 4. flash_f32 (f32): CUDA cores, no TF32 (the reference tolerance of
//    2e-5 does not admit it); it serves the tests.
//
// The decode, wgmma and mma.sync paths share one score epilogue: logits
// are kept in log2 units (scale * log2(e) folded into one multiply, and
// ex2.approx: one special-function instruction), the softcap is
// cap * (1 - 2 / (exp2(2 log2(e) x / cap) + 1)) with rcp.approx
// (absolute error ~1e-7 * cap against tanhf; tanh.approx's 2^-11 would
// move a logit at cap 50 by ~0.02), the per-element mask runs only on
// tiles that the diagonal, the window or the Sk edge cuts, and a row
// whose running max did not move skips the rescale of its accumulators
// (x * 1 == x).  Key tiles with no visible pair are skipped: they would
// leave m, l and acc unchanged bit for bit.
//
// The logsumexp: when the caller passes an f32 (B, H, Sq) `lse`, every
// path also writes each row's logsumexp in log2 units,
//
//   lse2 = log2(sum over visible keys of 2^(x * log2(e))) = m + log2(l)
//
// from the m (log2 units) and l it already holds (flash_f32's natural-unit
// m is multiplied by log2(e) first; the decode path's are flash_combine's
// merged ones); a row that sees no key (l = 0) gets NEG_INF, finite.  The
// backward (flash_attention_bwd.cu) reads it as P = 2^(x log2(e) - lse2).
// With lse null nothing else changes: the output is the same bits.
//
// Head dims: D a multiple of 8 up to 256.  k and v may be strided along
// batch, sequence and head (a decode reads a slice of the cache in
// place); the last dim is dense and rows are 16-byte aligned.  Every sum
// runs in a fixed order, so results are the same bits from call to call.
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); launches on the caller's stream and
// returns the launch's cudaError_t.  The TMA tensor-map encoder comes from
// libcuda through cudaGetDriverEntryPoint, so nothing links -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows a block (mma.sync, f32)
constexpr int kBK = 64;            // keys a tile (mma.sync, f32, wgmma)
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, has_window, window;
  float scale, cap;
  // the bf16 epilogue's constants (log2 units)
  float qk2;      // scale * log2(e)
  float cap_in;   // 2 log2(e) scale / cap
  float cap_out;  // cap * log2(e)
  // split-K decode
  float* part_ml;   // (B, Hkv, splits, R, 2): m (log2 units), l
  float* part_acc;  // (B, Hkv, splits, R, D)
  int splits, kps;  // splits, keys a split
  float* lse;       // (B, H, Sq) logsumexp in log2 units, or null
};

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  if (kp >= p.Sk) return false;
  if (p.causal && kp > qp) return false;
  if (p.has_window && !((long long)qp - kp < (long long)p.window)) {
    return false;
  }
  return true;
}

// Key tiles [t_begin, t_end) of nk keys that hold a pair visible from
// query rows [q0, q0 + nq); every tile outside is wholly masked.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int nq,
                                          int nk, int& t_begin, int& t_end) {
  const int q_last = min(q0 + nq, p.Sq) - 1;
  long long k_end = p.Sk;
  if (p.causal) k_end = min(k_end, (long long)q_last + 1);
  long long k_begin = 0;
  if (p.has_window) {
    // q - k < window  <=>  k >= q - window + 1, loosest for q = q0
    k_begin = max(0LL, (long long)q0 - (long long)p.window + 1);
  }
  if (k_begin >= k_end) {
    t_begin = t_end = 0;
    return;
  }
  t_begin = (int)(k_begin / nk);
  t_end = (int)((k_end + nk - 1) / nk);
}

// Whether some pair of rows [q_lo, q_hi] x keys [k0, k0 + nk) is masked
// (the tile is cut by the Sk edge, the causal diagonal or the window).
__device__ __forceinline__ bool tile_cut(const Params& p, int q_lo, int q_hi,
                                         int k0, int nk) {
  const long long k_last = (long long)k0 + nk - 1;
  if (k_last >= p.Sk) return true;
  if (p.causal && k_last > q_lo) return true;
  if (p.has_window && !((long long)q_hi - k0 < (long long)p.window)) {
    return true;
  }
  return false;
}

// Whether some pair of rows [q_lo, q_hi] x keys [k0, k0 + nk) is visible.
__device__ __forceinline__ bool tile_any(const Params& p, int q_lo, int q_hi,
                                         int k0, int nk) {
  if (k0 >= p.Sk) return false;
  if (p.causal && k0 > q_hi) return false;
  if (p.has_window &&
      !((long long)q_lo - ((long long)k0 + nk - 1) < (long long)p.window)) {
    return false;
  }
  return true;
}

// f32 path: the logit in natural units, accurate tanhf
__device__ __forceinline__ float logit(const Params& p, float acc) {
  float x = acc * p.scale;
  if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
  return x;
}

// 2^x and 1/x on the special-function unit, one instruction each (max
// relative error ~2^-22; subnormal results flush to 0): ex2(-1e30) = 0,
// rcp(inf) = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the other paths: the logit in log2 units (x * log2(e)), the softcap as
// cap * (1 - 2 / (exp2(2 log2(e) x / cap) + 1)): exp2(+inf) = inf gives
// +cap, exp2(-inf) = 0 gives -cap
__device__ __forceinline__ float logit2(const Params& p, float acc) {
  if (p.cap > 0.f) {
    const float e = ex2(acc * p.cap_in);
    return p.cap_out * (1.f - 2.f * rcp(e + 1.f));
  }
  return acc * p.qk2;
}

// a row's logsumexp in log2 units from its max m (log2 units) and sum l;
// NEG_INF for a row that sees no key
__device__ __forceinline__ float row_lse2(float m, float l) {
  return l > 0.f ? m + log2f(l) : kNegInf;
}

__device__ __forceinline__ void store_lse(const Params& p, int b, int h,
                                          int row, float lse2) {
  p.lse[((long long)b * p.H + h) * p.Sq + row] = lse2;
}

// ---------------------------------------------------------------------------
// shared helpers: mma.sync, cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_b(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// 16 bytes from device to shared memory without passing registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The online-softmax update of one warp's 16 rows (rows[0] = g, rows[1] =
// g + 8) over a 64-key score tile held as 8 m16n8 fragments, s[4 nt + e]
// at column k0 + 8 nt + 2 t + (e & 1) of row rows[e >> 1].  On entry s
// holds q . k; on return it holds p (f32), m (log2 units) and l are
// updated and the NO accumulators o (the same fragment layout) rescaled.
// `cut`: whether the tile may hold a masked pair (else no compare runs).
template <int NO>
__device__ __forceinline__ void softmax_tile(const Params& p, bool cut,
                                             int k0, int t,
                                             const int (&rows)[2],
                                             float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&o)[NO]) {
  uint32_t vis = 0xffffffffu;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = logit2(p, s[i]);
    if (cut) {
      const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      if (!visible(p, rows[(i >> 1) & 1], col)) {
        x = kNegInf;
        vis &= ~(1u << i);
      }
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float pe = (vis >> i) & 1u ? ex2(s[i] - m[(i >> 1) & 1]) : 0.f;
    s[i] = pe;
    sum[(i >> 1) & 1] += pe;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
  // a row whose max did not move keeps o as it is (x * 1 == x: the same
  // bits), which spares the D / 2 multiplies on most tiles
  if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
}

// The A fragment of k-step kk (keys 16 kk .. 16 kk + 15) of p . v from
// the score fragments, rounded to bf16: the m16n8 C layout of two
// neighbouring n8 blocks is the m16k16 A layout.
__device__ __forceinline__ void p_fragment(const float (&s)[32], int kk,
                                           uint32_t (&a)[4]) {
  const int i = 8 * kk;
  a[0] = pack_f(s[i], s[i + 1]);
  a[1] = pack_f(s[i + 2], s[i + 3]);
  a[2] = pack_f(s[i + 4], s[i + 5]);
  a[3] = pack_f(s[i + 6], s[i + 7]);
}

// ---------------------------------------------------------------------------
// bf16, D not in {64, 128, 256}: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// rows [r0, r0 + 64) of one (batch, head) slice into smem[row * ld + col]
// for col < D16, as one group of asynchronous copies (all in flight at
// once); rows past `limit` and columns past D read as zeros (a zero v row
// keeps garbage out of p . v where p is 0).
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long stride, int r0,
                                               int limit, int D, int D16,
                                               int ld) {
  const int cpr = D16 / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * cpr; i += kThreads) {
    const int row = i / cpr, col = (i % cpr) * 8;
    const bool ok = r0 + row < limit && col < D;
    cp_async16(dst + row * ld + col,
               ok ? src + (long long)(r0 + row) * stride + col : src, ok);
  }
  cp_async_commit();
}

__host__ __device__ constexpr int bf16_ld(int D) {
  return ((D + 15) / 16) * 16 + 8;  // +8: rows skew across banks
}

__host__ __device__ constexpr size_t bf16_smem(int D) {
  return (size_t)(kBQ + 2 * kBK) * bf16_ld(D) * sizeof(bf16);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bf16(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, D16 = (D + 15) & ~15, LD = bf16_ld(D);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * LD;
  bf16* Vs = Ks + kBK * LD;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile_bf16(Qs, qg, p.q_ss, q0, p.Sq, D, D16, LD);

  float o[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bool active = q0 + warp * 16 < p.Sq;

  int t_begin, t_end;
  key_tiles(p, q0, kBQ, kBK, t_begin, t_end);
  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done
    load_tile_bf16(Ks, kg, p.k_ss, k0, p.Sk, D, D16, LD);
    load_tile_bf16(Vs, vg, p.v_ss, k0, p.Sk, D, D16, LD);
    cp_async_wait<1>();  // q and k have landed; v may still be in flight
    __syncthreads();
    float s[32];
    if (active) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      for (int kc = 0; kc < D16; kc += 16) {
        const bf16* qa = Qs + (warp * 16 + g) * LD + kc + 2 * t;
        const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                               ld32(qa + 8 * LD + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* kb = Ks + (nt * 8 + g) * LD + kc + 2 * t;
          mma_bf16(s + 4 * nt, a, ld32(kb), ld32(kb + 8));
        }
      }
      const bool cut = tile_cut(p, q0, q0 + kBQ - 1, k0, kBK);
      softmax_tile<DMAX / 2>(p, cut, k0, t, rows, s, m, l, o);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;

    // acc += bf16(p) . v
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      p_fragment(s, kk, a);
      const bf16* vb = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < DMAX / 8; ++nd) {
        if (nd * 8 < D) {
          const bf16* c = vb + nd * 8;
          mma_bf16(o + 4 * nd, a, pack_b(c[0], c[LD]),
                   pack_b(c[8 * LD], c[9 * LD]));
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing left in flight (no key tile: q's group)

  if (!active) return;
  bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Sq) continue;
    if (p.lse != nullptr && t == 0) {
      store_lse(p, b, h, rows[r], row_lse2(m[r], l[r]));
    }
    const float den = fmaxf(l[r], 1e-30f);
    bf16* dst = og + (((long long)b * p.Sq + rows[r]) * p.H + h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DMAX / 8; ++nd) {
      if (nd * 8 < D) {
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_f(o[4 * nd + 2 * r] / den, o[4 * nd + 2 * r + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// split-K decode (f32 or bf16, G * Sq <= 64 rows a kv head)
// ---------------------------------------------------------------------------

constexpr int kDecBK = 32;       // keys a tile (a lane owns one)
constexpr int kDecRows = 64;     // rows a kv head at most (G * Sq)
constexpr int kMaxSplits = 4096; // flash_combine's (m, l) in 32 KB of smem
constexpr int kDecWarps = kThreads / 32;

template <typename T>
__host__ __device__ constexpr int dec_ld(int D) {
  return D * (int)sizeof(T) + 16;  // bytes a staged row; +16 skews banks
}

// cp.async ring stages: three tiles in flight (two where f32 at D 256
// would not fit shared memory with 64 rows of q)
template <typename T, int DMAX>
__host__ __device__ constexpr int dec_stages() {
  return sizeof(T) == 4 && DMAX > 128 ? 2 : 3;
}

// the ring, then q of RB rows as f32; after the loop the ring holds the
// four warps' (m, l, acc) (4 RB (D + 2) floats, less than the ring)
template <typename T>
size_t dec_smem(int D, int RB, int stages) {
  return (size_t)stages * 2 * kDecBK * dec_ld<T>(D) +
         (size_t)RB * D * sizeof(float);
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

// p rounded to v's type before p . v
__device__ __forceinline__ float round_as(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

__device__ __forceinline__ void store_as(bf16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_as(float* dst, float x) { *dst = x; }

// One block per (split, kv head hk x row block, batch b).  Row r of kv
// head hk is query head hk * G + r % G at position r / G; a block holds
// rows [r_base, r_base + Rb), Rb <= RB (all G * Sq rows when they fit).
// Warp w takes keys 8 w .. 8 w + 7 of every 32-key tile and keeps its own
// (m, l, acc); the four warps are merged in warp order at the end and the
// block writes the split's partials.
//
//   scores  lane = 8 part + kk: key kk of the warp's eight, chunks of 8
//           dims part, part + 4, ...; the four parts summed by shuffles
//   softmax each row over the warp's eight keys by shuffles
//   p . v   lane owns columns 8 lane .. 8 lane + 7; p of key kk comes
//           from lane kk by a shuffle
template <typename T, int DMAX, int RB>
__global__ void __launch_bounds__(kThreads) flash_decode(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EPV = 16 / (int)sizeof(T);     // elements a 16-byte chunk
  constexpr int NS = dec_stages<T, DMAX>();
  const int D = p.D, G = p.H / p.Hkv, R = G * p.Sq, LDB = dec_ld<T>(D);
  const int cpr = D / EPV, nrb = (R + RB - 1) / RB;
  unsigned char* ring = smem;
  float* Qf = reinterpret_cast<float*>(smem + NS * 2 * kDecBK * LDB);

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / nrb, r_base = (blockIdx.y % nrb) * RB;
  const int Rb = min(RB, R - r_base);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kk = lane & 7, part = lane >> 3;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // q rows as f32
  for (int i = tid; i < Rb * cpr; i += kThreads) {
    const int r = r_base + i / cpr, c = (i % cpr) * EPV;
    const T* src = static_cast<const T*>(p.q) + b * p.q_sb +
                   (r / G) * p.q_ss + (hk * G + r % G) * p.q_sh + c;
    float* dst = Qf + (i / cpr) * D + c;
    if constexpr (EPV == 8) {
      float x[8];
      load8(src, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = x[e];
    } else {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    }
  }

  // the split's keys [lo, hi), cut to those some row can see
  const long long lo = (long long)split * p.kps;
  const long long hi = min((long long)p.Sk, lo + p.kps);
  long long vis_lo = 0, vis_hi = p.Sk;
  if (p.causal) vis_hi = min(vis_hi, (long long)p.Sq);
  if (p.has_window) vis_lo = max(0LL, 1LL - (long long)p.window);
  const long long a0 = max(lo, vis_lo), e0 = min(hi, vis_hi);
  int t_begin = 0, nt = 0;
  if (a0 < e0) {
    t_begin = (int)((a0 - lo) / kDecBK);
    nt = (int)((e0 - lo + kDecBK - 1) / kDecBK) - t_begin;
  }

  // tile j into stage j % NS; past the end an empty group, so that the
  // wait below counts groups the same way on every tile
  auto issue = [&](int j) {
    if (j < nt) {
      const int k0 = (int)lo + (t_begin + j) * kDecBK;
      unsigned char* ks = ring + (j % NS) * 2 * kDecBK * LDB;
      unsigned char* vs = ks + kDecBK * LDB;
      for (int i = tid; i < kDecBK * cpr; i += kThreads) {
        const int row = i / cpr, c = (i % cpr) * EPV;
        const bool ok = k0 + row < p.Sk;
        const long long kr = ok ? k0 + row : 0;
        cp_async16(ks + row * LDB + c * (int)sizeof(T),
                   kg + kr * p.k_ss + c, ok);
        cp_async16(vs + row * LDB + c * (int)sizeof(T),
                   vg + kr * p.v_ss + c, ok);
      }
    }
    cp_async_commit();
  };

  float m[RB], l[RB], acc[RB][8];   // this warp's, replicated over lanes
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  const bool col_ok = lane * 8 < D;

  for (int j = 0; j < NS - 1; ++j) issue(j);
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<NS - 2>();   // tile j has landed (this thread's copies)
    __syncthreads();           // everyone's; tile j - 1's readers are done
    issue(j + NS - 1);         // into tile j - 1's stage
    const unsigned char* ks = ring + (j % NS) * 2 * kDecBK * LDB;
    const unsigned char* vs = ks + kDecBK * LDB;
    const int k0 = (int)lo + (t_begin + j) * kDecBK;
    const int key = 8 * warp + kk;
    const bool cut = tile_cut(p, 0, p.Sq - 1, k0, kDecBK);

    float sc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) sc[i] = 0.f;
    const T* krow = reinterpret_cast<const T*>(ks + key * LDB);
    for (int c = 8 * part; c < D; c += 32) {
      float kx[8];
      load8(krow + c, kx);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i < Rb) {
          float qx[8];
          load8(Qf + i * D + c, qx);
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[i] = fmaf(qx[e], kx[e], sc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (i < Rb) {
        sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], 8);
        sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], 16);
        const bool ok = !cut || visible(p, (r_base + i) / G, k0 + key);
        const float x = ok ? logit2(p, sc[i]) : kNegInf;
        float mx = x;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = ex2(m[i] - m_new);
        const float pe = ok ? ex2(x - m_new) : 0.f;
        float sum = pe;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
        sc[i] = pe;
        if (alpha != 1.f) {   // warp-uniform; x * 1 == x
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
        }
      }
    }

    // acc += round(p) . v over the warp's eight keys
    const T* vcol = reinterpret_cast<const T*>(vs + 8 * warp * LDB) + lane * 8;
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      float vx[8];
      if (col_ok) {
        load8(reinterpret_cast<const T*>(
                  reinterpret_cast<const unsigned char*>(vcol) + k2 * LDB),
              vx);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i < Rb) {
          const float pe =
              round_as(__shfl_sync(0xffffffffu, sc[i], k2), vcol);
          if (col_ok) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pe, vx[e], acc[i][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the warps' states now

  float* wm = reinterpret_cast<float*>(ring);   // [4][RB]
  float* wl = wm + kDecWarps * RB;               // [4][RB]
  float* wacc = wl + kDecWarps * RB;             // [4][RB][D]
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    if (i < Rb) {
      if (lane == 0) {
        wm[warp * RB + i] = m[i];
        wl[warp * RB + i] = l[i];
      }
      if (col_ok) {
        float4* dst =
            reinterpret_cast<float4*>(wacc + (warp * RB + i) * D + lane * 8);
        dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
  __syncthreads();

  // the warps merged in warp order: the split's partials
  const long long base =
      ((long long)(b * p.Hkv + hk) * p.splits + split) * R + r_base;
  for (int idx = tid; idx < Rb * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, wm[w * RB + i]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float sw = ex2(wm[w * RB + i] - M);
      L += wl[w * RB + i] * sw;
      A += wacc[(w * RB + i) * D + d] * sw;
    }
    p.part_acc[(base + i) * D + d] = A;
    if (d == 0) {
      p.part_ml[(base + i) * 2] = M;
      p.part_ml[(base + i) * 2 + 1] = L;
    }
  }
}

// One block per (row r, kv head, batch): the splits' partials merged in
// split order, m = max m_s, l = sum l_s 2^(m_s - m), out = sum acc_s
// 2^(m_s - m) / max(l, 1e-30) (m in log2 units).  The splits' (m_s, l_s)
// are read in parallel into shared memory first, so no thread waits on a
// chain of dependent loads.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_combine(Params p) {
  extern __shared__ float sml[];   // m_s, then l_s
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int D = p.D, G = p.H / p.Hkv, R = G * p.Sq, S = p.splits;
  const long long base = (long long)(b * p.Hkv + hk) * S * R + r;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    sml[s] = p.part_ml[(base + s * R) * 2];
    sml[S + s] = p.part_ml[(base + s * R) * 2 + 1];
  }
  __syncthreads();
  float m = kNegInf;
  for (int s = 0; s < S; ++s) m = fmaxf(m, sml[s]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) l += sml[S + s] * exp2f(sml[s] - m);
  const float den = fmaxf(l, 1e-30f);
  if (p.lse != nullptr && threadIdx.x == 0) {
    store_lse(p, b, hk * G + r % G, r / G, row_lse2(m, l));
  }
  T* dst = static_cast<T*>(p.o) +
           (((long long)b * p.Sq + r / G) * p.H + hk * G + r % G) * D;
  const float* acc = p.part_acc + base * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      o += acc[(long long)s * R * D + d] * exp2f(sml[s] - m);
    }
    store_as(dst + d, o / den);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kLdS = kBK + 1;      // score tile row stride

__host__ __device__ constexpr size_t f32_smem(int D) {
  return (size_t)(2 * kBQ * (D + 1) + kBK * D + kBQ * kLdS + 2 * kBQ) *
         sizeof(float);
}

// rows [r0, r0 + 64) into dst[row * ld + col], col < D; rows past `limit`
// read as zeros
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int limit, int D, int ld) {
  const int cpr = D / 4;
  for (int i = threadIdx.x; i < 64 * cpr; i += kThreads) {
    const int row = i / cpr, col = (i % cpr) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < limit) {
      val = *reinterpret_cast<const float4*>(src + (long long)(r0 + row) *
                                                       stride + col);
    }
    float* d = dst + row * ld + col;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads) flash_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, LDQ = D + 1;  // +1: the score loop reads columns
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDQ;      // row stride D
  float* Ss = Vs + kBK * D;        // scores, then p
  float* s_alpha = Ss + kBQ * kLdS;
  float* s_l = s_alpha + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;     // 8-row group, column lane
  const int srow = tid >> 1, half = tid & 1;  // softmax: 2 threads a row
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile_f32(Qs, qg, p.q_ss, q0, p.Sq, D, LDQ);

  constexpr int NJ = DMAX / 16;
  float o[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;
  }
  float m_r = kNegInf, l_r = 0.f;  // row srow's stats (both halves)

  int t_begin, t_end;
  key_tiles(p, q0, kBQ, kBK, t_begin, t_end);
  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile_f32(Ks, kg, p.k_ss, k0, p.Sk, D, LDQ);
    load_tile_f32(Vs, vg, p.v_ss, k0, p.Sk, D, D);
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = Qs[(rg * 8 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg * 8 + i, c = cg + 16 * j;
        Ss[r * kLdS + c] = visible(p, q0 + r, k0 + c) ? logit(p, acc[i][j])
                                                      : kNegInf;
      }
    }
    __syncthreads();

    {  // softmax over row srow, columns half*32 .. half*32+31
      float* srow_p = Ss + srow * kLdS + half * 32;
      float mx = kNegInf;
      for (int c = 0; c < 32; ++c) mx = fmaxf(mx, srow_p[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_r, mx);
      const float alpha = expf(m_r - m_new);
      float sum = 0.f;
      for (int c = 0; c < 32; ++c) {
        const float pe = visible(p, q0 + srow, k0 + half * 32 + c)
                             ? expf(srow_p[c] - m_new) : 0.f;
        srow_p[c] = pe;
        sum += pe;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_r = l_r * alpha + sum;
      m_r = m_new;
      if (half == 0) s_alpha[srow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = s_alpha[rg * 8 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= a;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[8], vv[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ss[(rg * 8 + i) * kLdS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        vv[j] = d < D ? Vs[kk * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
      }
    }
  }

  if (half == 0) {
    s_l[srow] = l_r;
    if (p.lse != nullptr && q0 + srow < p.Sq) {
      store_lse(p, b, h, q0 + srow, row_lse2(m_r * kLog2e, l_r));
    }
  }
  __syncthreads();
  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    if (q0 + r >= p.Sq) continue;
    const float den = fmaxf(s_l[r], 1e-30f);
    float* dst = og + (((long long)b * p.Sq + q0 + r) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) dst[d] = o[i][j] / den;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16, D in {64, 128, 256}: wgmma + TMA prefill
// ---------------------------------------------------------------------------
//
// Bound by operations: 4 D flops a visible (q, k) pair, on the tensor cores
// at 989 TFLOP/s.  A block owns 128 query rows of one (b, h), two consumer
// warpgroups of 64 rows each (256 threads), and loops over 64-key tiles:
//
//   shared memory  Q (128 x D, loaded once) and a ring of two stages of k
//                  and v tiles (64 x D each), all in the 128-byte-swizzled
//                  layout that TMA writes and wgmma reads: per 64 columns
//                  of D an atom column of rows x 128 bytes.  At D = 256
//                  64 KB + 2 x 64 KB = 192 KB: one block an SM.
//   TMA            4-D tensor maps over (D, S, heads, B) with the tensors'
//                  own strides, so k and v are read as cache slices in
//                  place, and rows past Sq / Sk are zero-filled.  Thread 0
//                  issues tile j + 1 behind a "full" mbarrier while both
//                  warpgroups compute tile j; every thread arrives on the
//                  stage's "empty" mbarrier when done with it, and thread
//                  0 waits on that before reloading the stage, so the two
//                  warpgroups are not held in step tile by tile.
//   S = Q . K^T    wgmma m64n64k16, A and B from shared memory, K-major:
//                  D / 16 k-steps.
//   softmax        the shared epilogue on S in registers (the m64n64 f32
//                  accumulator is eight m16n8 fragments a warp).
//   O += P . V     wgmma m64nDk16, A = P from registers (S rounded to bf16
//                  in place: the accumulator layout is the register-A
//                  layout), B = the v tile, MN-major (transposed B).
//   registers      O is D / 2 f32 a thread (128 at D = 256), S 32.
//
// Key tiles above the diagonal or outside the window are not loaded; a
// warpgroup skips the products of a tile none of its rows sees.  The
// query tiles with the most key tiles launch first (blockIdx.z reversed),
// so the causal tail is short.

constexpr int kWgRows = 128;          // query rows a block
constexpr int kWgThreads = 256;       // two warpgroups

// 64-bit shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), and the
// swizzle mode (1: 128 B) in bits 62-63.  K-major: SBO = 1024 (8 rows of
// 128 B), LBO unused.  MN-major: LBO = the distance between 64-column atom
// columns, SBO = 1024 (8 rows of k).
__device__ __forceinline__ uint64_t smem_desc(const void* ptr, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the barrier
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

// d[32] += A (smem, K-major) . B (smem, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
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
      : "l"(da), "l"(db), "r"(scale_d));
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

// d[128] += A (registers) . B (smem, MN-major: transposed), m64n256k16
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n256(o, a, db);
  }
}

template <int D>
__host__ __device__ constexpr size_t wg_smem() {
  // 1024 bytes of slack to align the swizzled tiles, Q, two stages of k
  // and v, three mbarriers
  return 1024 + (size_t)kWgRows * D * 2 + 4 * (size_t)kBK * D * 2 + 64;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_prefill_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int NA = D / 64;                  // 64-column atom columns
  constexpr uint32_t QA = kWgRows * 128;      // bytes of a Q atom column
  constexpr uint32_t TA = kBK * 128;          // ... of a k or v atom column
  constexpr uint32_t TILE = NA * TA;          // bytes of a k or v tile
  unsigned char* Qs =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = Qs + NA * QA;         // stage s: k, then v
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 4 * TILE);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWgRows;  // longest first
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  int t_begin, t_end;
  key_tiles(p, q0, kWgRows, kBK, t_begin, t_end);
  const int n = t_end - t_begin;

  // bars: full[2] (TMA landed), q, empty[2] (all 256 threads done with
  // the stage)
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    mbar_init(&bars[3], kWgThreads);
    mbar_init(&bars[4], kWgThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: key tile t_begin + j into stage j & 1, once tile j - 2 has
  // been read there
  auto load_kv = [&](int j) {
    unsigned char* ks = ring + (j & 1) * 2 * TILE;
    const int k0 = (t_begin + j) * kBK;
    if (j >= 2) mbar_wait(&bars[3 + (j & 1)], ((j - 2) >> 1) & 1);
    mbar_expect_tx(&bars[j & 1], 2 * TILE);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load_4d(ks + a * TA, &tk, a * 64, k0, hk, b, &bars[j & 1]);
      tma_load_4d(ks + TILE + a * TA, &tv, a * 64, k0, hk, b, &bars[j & 1]);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[2], NA * QA);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load_4d(Qs + a * QA, &tq, a * 64, q0, h, b, &bars[2]);
    }
    if (n > 0) load_kv(0);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int wq_lo = q0 + wg * 64, wq_hi = wq_lo + 63;
  const int rows[2] = {wq_lo + warp * 16 + g, wq_lo + warp * 16 + g + 8};
  const unsigned char* Qw = Qs + wg * 64 * 128;  // this warpgroup's rows

  mbar_wait(&bars[2], 0);
  for (int j = 0; j < n; ++j) {
    if (tid == 0 && j + 1 < n) load_kv(j + 1);
    __syncwarp();
    mbar_wait(&bars[j & 1], (j >> 1) & 1);
    const int k0 = (t_begin + j) * kBK;
    // warpgroup-uniform: skip a tile none of this warpgroup's rows sees
    if (wq_lo < p.Sq && tile_any(p, wq_lo, wq_hi, k0, kBK)) {
      const unsigned char* ks = ring + (j & 1) * 2 * TILE;
      const unsigned char* vs = ks + TILE;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        // k-step kc: atom column kc / 4, 32 bytes in per step inside it
        const int a = kc >> 2, kb = (kc & 3) * 32;
        wgmma_ss_n64(s, smem_desc(Qw + a * QA + kb, 16, 1024),
                     smem_desc(ks + a * TA + kb, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      softmax_tile<D / 2>(p, tile_cut(p, wq_lo, wq_hi, k0, kBK), k0, t,
                          rows, s, m, l, o);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) p_fragment(s, kk, pa[kk]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // keys 16 kk .. 16 kk + 15: two 8-row groups of every atom column
        wgmma_rs<D>(o, pa[kk], smem_desc(vs + kk * 16 * 128, TA, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    mbar_arrive(&bars[3 + (j & 1)]);  // stage j & 1 may take tile j + 2
  }

  bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Sq) continue;
    if (p.lse != nullptr && t == 0) {
      store_lse(p, b, h, rows[r], row_lse2(m[r], l[r]));
    }
    const float den = fmaxf(l[r], 1e-30f);
    bf16* dst = og + (((long long)b * p.Sq + rows[r]) * p.H + h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          pack_f(o[4 * nd + 2 * r] / den, o[4 * nd + 2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DMAX>
cudaError_t launch_bf16(const Params& p, cudaStream_t s) {
  // once per instantiation, before any CUDA graph capture of the launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bf16_smem(DMAX));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_bf16<DMAX><<<grid, kThreads, bf16_smem(p.D), s>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)f32_smem(DMAX));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_f32<DMAX><<<grid, kThreads, f32_smem(p.D), s>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX, int RB>
cudaError_t launch_decode(const Params& p, cudaStream_t s) {
  constexpr int NS = dec_stages<T, DMAX>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode<T, DMAX, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dec_smem<T>(DMAX, RB, NS));
  if (attr != cudaSuccess) return attr;
  const int R = p.H / p.Hkv * p.Sq, nrb = (R + RB - 1) / RB;
  if ((long long)p.Hkv * nrb > 65535) return cudaErrorInvalidConfiguration;
  flash_decode<T, DMAX, RB><<<dim3(p.splits, p.Hkv * nrb, p.B), kThreads,
                              dec_smem<T>(p.D, RB, NS), s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_combine<T><<<dim3(R, p.Hkv, p.B), kThreads,
                     2 * p.splits * sizeof(float), s>>>(p);
  return cudaGetLastError();
}

// rows a block: all of a kv head's up to 4, else blocks of 16
template <typename T, int DMAX>
cudaError_t launch_decode_r(const Params& p, cudaStream_t s) {
  if (p.H / p.Hkv * p.Sq <= 4) return launch_decode<T, DMAX, 4>(p, s);
  return launch_decode<T, DMAX, 16>(p, s);
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

// a 4-D map over a (B, S, heads, D) bf16 tensor, innermost first, with its
// own strides (elements); boxes of 64 columns x `rows` rows, 128-byte
// swizzle, zeros outside
bool tensor_map(CUtensorMap* map, const void* base, int D, int S, int heads,
                int B, long long ss, long long sh, long long sb, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(S > 0 ? S : 1),
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wg_smem<D>());
  if (attr != cudaSuccess) return attr;
  const int nqt = (p.Sq + kWgRows - 1) / kWgRows;
  if (nqt > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                  kWgRows) ||
      !tensor_map(&tk, p.k, D, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb,
                  kBK) ||
      !tensor_map(&tv, p.v, D, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb,
                  kBK)) {
    return cudaErrorInvalidValue;
  }
  flash_prefill_wgmma<D><<<dim3(p.H, p.B, nqt), kWgThreads, wg_smem<D>(),
                           s>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_d(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return launch_decode_r<T, 64>(p, s);
  if (p.D <= 128) return launch_decode_r<T, 128>(p, s);
  return launch_decode_r<T, 256>(p, s);
}

}  // namespace

// path: 0 split-K decode, 1 wgmma prefill, 2 mma.sync (bf16), 3 CUDA
// cores (f32), as kernels/flash_attention.py chooses.  dtype: 0 float32,
// 1 bfloat16.  Strides are in elements; the last dim of q, k and v is
// dense, the output (B, Sq, H, D) contiguous.  part_ml / part_acc: the
// decode's f32 scratch, (B, Hkv, splits, G Sq, 2) and (..., D); `kps`
// keys a split.  lse: an f32 (B, H, Sq) for each row's logsumexp (log2
// units, the header's), or null.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal,
    int has_window, int window, float scale, float cap, int dtype, int path,
    void* part_ml, void* part_acc, int splits, int kps, void* lse,
    void* stream) {
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
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  p.qk2 = scale * kLog2e;
  p.cap_in = cap > 0.f ? 2.f * kLog2e * scale / cap : 0.f;
  p.cap_out = cap * kLog2e;
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.splits = splits;
  p.kps = kps;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (path) {
    case 0: {
      const long long R = (long long)(H / Hkv) * Sq;
      if (R > kDecRows || splits < 1 || splits > kMaxSplits || kps < 1 ||
          kps % kDecBK != 0 ||
          (long long)splits * kps < Sk || !part_ml || !part_acc) {
        return (int)cudaErrorInvalidValue;
      }
      return dtype == 1 ? (int)launch_decode_d<bf16>(p, s)
                        : (int)launch_decode_d<float>(p, s);
    }
    case 1:
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      if (D == 64) return (int)launch_wgmma<64>(p, s);
      if (D == 128) return (int)launch_wgmma<128>(p, s);
      if (D == 256) return (int)launch_wgmma<256>(p, s);
      return (int)cudaErrorInvalidValue;
    case 2:
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      if (D <= 64) return (int)launch_bf16<64>(p, s);
      if (D <= 128) return (int)launch_bf16<128>(p, s);
      return (int)launch_bf16<256>(p, s);
    case 3:
      if (dtype != 0) return (int)cudaErrorInvalidValue;
      if (D <= 64) return (int)launch_f32<64>(p, s);
      if (D <= 128) return (int)launch_f32<128>(p, s);
      return (int)launch_f32<256>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
