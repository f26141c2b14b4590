// hot_gather — the fast-path table cache (Morpheus §4.3.1) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/hot_gather.py
// (hot_gather_kernel, body _kernel).  Computes out[t] = table[idx[t]]
// bit for bit: rows whose id is in hot_ids come from hot_rows (a
// verbatim copy of those table rows), all other rows from the table at
// idx clamped to [0, V-1], as the TPU kernel clamps.  The kernel copies
// bytes and does no arithmetic on the values, so one instantiation per
// access width serves every element type (the wrapper admits f32 and
// bf16).
//
// Bound: bytes.  The work is T output rows written plus the input rows
// read; there are no operations to speak of.  A hot row of the smoke's
// width (4096 x 4 B = 16 KB) times 32 hot rows is 512 KB, more than an
// SM's 227 KB of shared memory, so the hot set cannot be staged whole.
// The grid is therefore (token blocks x D-tiles): each CTA stages its
// D-tile of every hot row in shared memory (at most 48 KB) with cp.async,
// resolves hit / position for its tokens with all threads over (token,
// hot id) pairs while those copies are in flight, and copies hot rows
// from shared memory and cold rows from global memory with the widest
// access (16 bytes where row size and pointers allow).  A hot set too
// large to stage even one 16-byte column of is read from hot_rows in
// global memory.
//
// Plain C interface, built with nvcc -shared and loaded through ctypes
// (repro_torch/kernels/build.py); launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTokensPerBlock = 32;
constexpr int kSmemBudget = 48 * 1024;   // no opt-in attribute needed
constexpr int kMaxTileBytes = 4096;
constexpr int kMiss = 0x7fffffff;

// global -> shared copy that does not wait for the data (cp.async) where
// the access width allows it (4, 8 or 16 bytes)
template <typename Vec>
__device__ __forceinline__ void copy_to_shared(Vec* dst, const Vec* src) {
  if constexpr (sizeof(Vec) >= 4) {
    __pipeline_memcpy_async(dst, src, sizeof(Vec));
  } else {
    *dst = *src;
  }
}

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
hot_gather_kernel(const Vec* __restrict__ table,
                  const Vec* __restrict__ hot_rows,
                  const int32_t* __restrict__ hot_ids,
                  const int32_t* __restrict__ idx,
                  Vec* __restrict__ out,
                  int V, int Hn, int T,
                  int64_t row_vecs, int tile_vecs, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Vec* s_hot = reinterpret_cast<Vec*>(smem_raw);   // Hn x tile_vecs
  __shared__ int s_pos[kTokensPerBlock];   // first hot position, or kMiss
  __shared__ int s_id[kTokensPerBlock];

  const int tok0 = blockIdx.x * kTokensPerBlock;
  const int64_t v0 = (int64_t)blockIdx.y * tile_vecs;
  const int64_t rest = row_vecs - v0;
  const int nv = rest < tile_vecs ? (int)rest : tile_vecs;
  const int ntok = min(kTokensPerBlock, T - tok0);

  // stage this D-tile of every hot row; the copies fly while the
  // tokens are resolved below
  if (staged) {
    for (int i = threadIdx.x; i < Hn * nv; i += kThreads) {
      const int h = i / nv;
      const int v = i - h * nv;
      copy_to_shared(&s_hot[h * tile_vecs + v],
                     &hot_rows[h * row_vecs + v0 + v]);
    }
    __pipeline_commit();
  }
  if (threadIdx.x < ntok) {
    s_id[threadIdx.x] = idx[tok0 + threadIdx.x];
    s_pos[threadIdx.x] = kMiss;
  }
  __syncthreads();
  // resolve every (token, hot position) pair in parallel; the first
  // matching position wins, as in the reference's argmax
  for (int i = threadIdx.x; i < ntok * Hn; i += kThreads) {
    const int t = i / Hn;
    const int h = i - t * Hn;
    if (hot_ids[h] == s_id[t]) atomicMin(&s_pos[t], h);
  }
  if (staged) __pipeline_wait_prior(0);
  __syncthreads();

  // neighbouring threads copy neighbouring vectors of one row
#pragma unroll 4
  for (int i = threadIdx.x; i < ntok * nv; i += kThreads) {
    const int t = i / nv;
    const int v = i - t * nv;
    const int pos = s_pos[t];
    Vec val;
    if (pos != kMiss) {
      val = staged ? s_hot[pos * tile_vecs + v]
                   : hot_rows[pos * row_vecs + v0 + v];
    } else {
      const int row = min(max(s_id[t], 0), V - 1);
      val = table[row * row_vecs + v0 + v];
    }
    out[(tok0 + t) * row_vecs + v0 + v] = val;
  }
}

template <typename Vec>
cudaError_t launch(const void* table, const void* hot_rows,
                   const int32_t* hot_ids, const int32_t* idx, void* out,
                   int V, int Hn, int T, int64_t row_bytes,
                   cudaStream_t stream) {
  const int vec = (int)sizeof(Vec);
  const int64_t row_vecs = row_bytes / vec;
  // widest power-of-two tile (in bytes) whose slice of every hot row
  // fits the shared-memory budget
  int tile_bytes = kMaxTileBytes;
  while (tile_bytes > vec && (int64_t)Hn * tile_bytes > kSmemBudget) {
    tile_bytes /= 2;
  }
  const int staged = (int64_t)Hn * tile_bytes <= kSmemBudget;
  int tile_vecs = tile_bytes / vec;
  if ((int64_t)tile_vecs > row_vecs) tile_vecs = (int)row_vecs;
  const size_t smem = staged ? (size_t)Hn * tile_vecs * vec : 0;
  const int64_t n_tiles = (row_vecs + tile_vecs - 1) / tile_vecs;
  if (n_tiles > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((T + kTokensPerBlock - 1) / kTokensPerBlock, (unsigned)n_tiles);
  hot_gather_kernel<Vec><<<grid, kThreads, smem, stream>>>(
      static_cast<const Vec*>(table), static_cast<const Vec*>(hot_rows),
      hot_ids, idx, static_cast<Vec*>(out), V, Hn, T, row_vecs, tile_vecs,
      staged);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hot_gather_launch(const void* table, const void* hot_rows,
                                 const int32_t* hot_ids, const int32_t* idx,
                                 void* out, int V, int Hn, int T,
                                 long long row_bytes, void* stream) {
  if (T == 0 || row_bytes == 0) return 0;
  // the widest access that divides the row size and every row base
  const uintptr_t a = (uintptr_t)table | (uintptr_t)hot_rows |
                      (uintptr_t)out | (uintptr_t)row_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a % 16 == 0) {
    err = launch<uint4>(table, hot_rows, hot_ids, idx, out, V, Hn, T,
                        row_bytes, s);
  } else if (a % 8 == 0) {
    err = launch<uint2>(table, hot_rows, hot_ids, idx, out, V, Hn, T,
                        row_bytes, s);
  } else if (a % 4 == 0) {
    err = launch<uint32_t>(table, hot_rows, hot_ids, idx, out, V, Hn, T,
                           row_bytes, s);
  } else {
    err = launch<uint16_t>(table, hot_rows, hot_ids, idx, out, V, Hn, T,
                           row_bytes, s);
  }
  return (int)err;
}

extern "C" const char* hot_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
