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
// Bound: operations for prefill, bytes for decode.  A gemma2-9b prefill
// layer (B 2, S 6144, H 16, D 256) is ~0.6 TFLOP of products over
// ~0.2 GB; a decode step (Sq 1) reads the whole cache slice once and does
// 4 flops per byte.  The TPU kernel walks the key blocks of one query
// block in order (the sequential grid axis ik) with (m, l, acc) in VMEM
// scratch.  Here one block of 128 threads owns (b, h, 64 query rows) and
// loops over 64-key tiles itself, staging each k and v tile in shared
// memory with cp.async (every 16-byte copy of a tile in flight at once,
// and v's copy overlapping the score phase); m, l and acc stay in
// registers.  Key tiles wholly above the
// causal diagonal or wholly outside the window are skipped: every pair in
// them is masked, so they would leave m, l and acc unchanged bit for bit.
//
//   bf16: four warps, 16 query rows each, products on the tensor cores
//         with mma.sync m16n8k16 (bf16 in, f32 accumulate).  The score
//         fragment of q . k^T is reused in registers as the A operand of
//         p . v.  Warps whose rows all lie past Sq skip the products
//         (decode: Sq = 1 leaves three of four warps idle, and 63 of the
//         64 rows of the first wasted; split-K decoding is later work).
//   f32:  no TF32 (the reference tolerance of 2e-5 does not admit it):
//         products on the CUDA cores, 8 x 4 score and 8 x D/16 output
//         register tiles a thread, the score tile in shared memory, tiles
//         loaded through registers (this path serves the tests, not the
//         model's bf16 main path).
//
// Head dims: D a multiple of 8 up to 256 (templates for 64, 128, 256 size
// the register accumulators).  k and v may be strided along batch,
// sequence and head (a decode reads a slice of the cache in place); the
// last dim is dense and rows are 16-byte aligned.  Every sum runs in a
// fixed order and nothing is accumulated with atomics, so results are
// the same bits from call to call.  Not used yet: wgmma, TMA, warp
// specialisation, a ring of tiles (the next tile's copy does not overlap
// this tile's products), split-K decoding.
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

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
};

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  if (kp >= p.Sk) return false;
  if (p.causal && kp > qp) return false;
  if (p.has_window && !((long long)qp - kp < (long long)p.window)) {
    return false;
  }
  return true;
}

// Key tiles [t_begin, t_end) that hold a pair visible from query rows
// [q0, q0 + kBQ); every tile outside is wholly masked.
__device__ __forceinline__ void key_tiles(const Params& p, int q0,
                                          int& t_begin, int& t_end) {
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
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
  t_begin = (int)(k_begin / kBK);
  t_end = (int)((k_end + kBK - 1) / kBK);
}

__device__ __forceinline__ float logit(const Params& p, float acc) {
  float x = acc * p.scale;
  if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
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

// The score tile of one warp (16 rows x 64 keys, as 8 m16n8 fragments):
// q . k^T on the tensor cores, then softcap, mask and the online softmax
// update.  On return s holds p (f32) and m, l and acc (o) are rescaled.
template <int DMAX>
__device__ __forceinline__ void scores_softmax(
    const Params& p, const bf16* Qs, const bf16* Ks, int LD, int D16, int k0,
    int warp, int g, int t, const int (&rows)[2], float (&s)[8][4],
    float (&m)[2], float (&l)[2], float (&o)[DMAX / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
  for (int kc = 0; kc < D16; kc += 16) {
    const bf16* qa = Qs + (warp * 16 + g) * LD + kc + 2 * t;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                           ld32(qa + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* kb = Ks + (nt * 8 + g) * LD + kc + 2 * t;
      mma_bf16(s[nt], a, ld32(kb), ld32(kb + 8));
    }
  }

  // softcap, mask, running max over the row (4 threads share a row)
  uint32_t vis = 0;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * t + (e & 1);
      const bool ok = visible(p, rows[e >> 1], col);
      const float x = ok ? logit(p, s[nt][e]) : kNegInf;
      s[nt][e] = x;
      vis |= (uint32_t)ok << (nt * 4 + e);
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = (vis >> (nt * 4 + e)) & 1u
                           ? expf(s[nt][e] - m[e >> 1]) : 0.f;
      s[nt][e] = pe;
      sum[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
#pragma unroll
  for (int nd = 0; nd < DMAX / 8; ++nd) {
    o[nd][0] *= alpha[0];
    o[nd][1] *= alpha[0];
    o[nd][2] *= alpha[1];
    o[nd][3] *= alpha[1];
  }
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

  float o[DMAX / 8][4];
#pragma unroll
  for (int nd = 0; nd < DMAX / 8; ++nd) {
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bool active = q0 + warp * 16 < p.Sq;

  int t_begin, t_end;
  key_tiles(p, q0, t_begin, t_end);
  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done
    load_tile_bf16(Ks, kg, p.k_ss, k0, p.Sk, D, D16, LD);
    load_tile_bf16(Vs, vg, p.v_ss, k0, p.Sk, D, D16, LD);
    cp_async_wait<1>();  // q and k have landed; v may still be in flight
    __syncthreads();
    float s[8][4];
    if (active) {
      scores_softmax<DMAX>(p, Qs, Ks, LD, D16, k0, warp, g, t, rows, s, m, l,
                           o);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;

    // acc += bf16(p) . v: the score fragments of keys 16kk..16kk+15 are
    // the A fragment of that k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_f(s[2 * kk][0], s[2 * kk][1]),
                             pack_f(s[2 * kk][2], s[2 * kk][3]),
                             pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vb = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < DMAX / 8; ++nd) {
        if (nd * 8 < D) {
          const bf16* c = vb + nd * 8;
          mma_bf16(o[nd], a, pack_b(c[0], c[LD]),
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
    const float den = fmaxf(l[r], 1e-30f);
    bf16* dst = og + (((long long)b * p.Sq + rows[r]) * p.H + h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DMAX / 8; ++nd) {
      if (nd * 8 < D) {
        *reinterpret_cast<uint32_t*>(dst + nd * 8) =
            pack_f(o[nd][2 * r] / den, o[nd][2 * r + 1] / den);
      }
    }
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
  key_tiles(p, q0, t_begin, t_end);
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

  if (half == 0) s_l[srow] = l_r;
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the last dim of
// q, k and v is dense, the output (B, Sq, H, D) contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal,
    int has_window, int window, float scale, float cap, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      D < 8 || D > 256 || D % 8 != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  Params p{q,    k,    v,    o,    B,    Sq,   Sk,     H,          Hkv,
           D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,   v_sb,       v_ss,
           v_sh, causal, has_window, window, scale, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return (int)launch_bf16<64>(p, s);
    if (D <= 128) return (int)launch_bf16<128>(p, s);
    return (int)launch_bf16<256>(p, s);
  }
  if (D <= 64) return (int)launch_f32<64>(p, s);
  if (D <= 128) return (int)launch_f32<128>(p, s);
  return (int)launch_f32<256>(p, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
