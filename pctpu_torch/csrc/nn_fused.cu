// Hand-written Hopper kernels, built by nvcc with the other sources of csrc/
// into one shared library with a plain C interface
// (pctpu_torch/ops/_cuda.py) and launched through ctypes on PyTorch's
// current stream.
//
// The unpruned fused 1-NN.  Replaces the TPU kernel
// pctpu/ops/pallas_knn.py:38 (_nn_kernel, called by pallas_nn_1 at :84): for
// every query a running minimum of the score |t|² − 2·q·t over every target
// and its index, so the (Q, T) matrix never exists.  The |q|² term is
// constant per query and left out; the wrapper re-derives the winner's exact
// d².
//
// It computes what the TPU kernel computes, with each step written as a
// correctly rounded intrinsic, so that its plain twin
// (cuda_knn.nn_1_fused_reference) can agree bit for bit:
//   cross = fma(qz, tz, fma(qy, ty, qx·tx));
//   |t|²  = fma(tz, tz, fma(ty, ty, tx·tx)); masked and padded targets carry
//           3e38, as pctpu's _plane_layout gives them (pallas_knn.py:64-80);
//   score = fma(−2, cross, |t|²), equal to pctpu's t_sq − 2.0·cross because
//           2·cross is exact.
// The winner is the first minimum: the lowest index among the targets whose
// score is the least, and index 0 when no score lies below 3e38.  A NaN score
// (a NaN or infinite coordinate) never wins.
//
// What bounds it on the card: operations.  Q·T pairs of 8 flop each on the
// CUDA cores: K = 3 is too narrow for the tensor cores (wgmma), and TF32
// would move winners.  No pruning: the pass is Q·T work whatever the
// geometry.  The bound's 8 flop are four instructions a pair (a
// multiply and three fma); a minimum has to be kept on top, so five is the
// least a pair can cost here.
//
// Design (pctpu_nn_fused, one C call = three launches):
//   nn_fused_prep_kernel packs the target once as float4 (x, y, z, |t|² or
//     3e38), padded to whole tiles with (0, 0, 0, 3e38), and sets every
//     query's key to all ones.  At 65,536 targets the packed target is 1 MB
//     and stays in the L2 cache for the main kernel.
//   nn_fused_main_kernel: a 2-D grid, query tile × target split, so that the
//     card is full at any Q (the first design's one block a 256 queries left
//     half the SMs idle at Q = 16,384).  A block of 128 threads holds 512
//     queries, four a thread in registers, so one 16-byte broadcast load from
//     shared memory serves four pairs.  Target tiles of 512 points come in
//     with cp.async through a ring of three, so the copy of tile k + 2 runs
//     under the scan of tile k; one __syncthreads a tile.  The inner loop keeps
//     only the minimum's value (one fminf a pair; fminf drops a NaN) and, for
//     every 32 targets, whether the minimum strictly improved there.  The index
//     is recovered afterwards: the chunk of 32 in which the minimum was first
//     reached is scanned again for the first target whose score equals it —
//     the same instructions on the same numbers, so equality is exact and the
//     first-minimum rule holds.  Splits merge through one 64-bit key a query,
//     atomicMin of (order-preserving score bits << 32 | index): among equal
//     scores the lower index wins, which is the first minimum.  A split whose
//     minimum stayed at 3e38 writes nothing, so such a query ends at index 0.
//   nn_fused_finish_kernel: key -> index (all ones -> 0).
//
// The first design (one thread a query, 256 queries a block, every target
// staged and scanned by every block, a compare and two selects a pair) stays
// below as pctpu_nn_fused_v1, so that old, new and twin can be held and timed
// in one call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3e38f;
constexpr int kTile = 512;     // targets a tile (8 KB as float4)
constexpr int kStages = 3;     // tiles in the ring
constexpr int kChunk = 32;     // targets between two looks at the minimum
constexpr int kThreads = 128;  // threads of a main block
constexpr int kPer = 4;        // queries a thread
constexpr int kQueries = kThreads * kPer;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float score_of(float qx, float qy, float qz, const float4& v) {
  const float cross = __fmaf_rn(qz, v.z, __fmaf_rn(qy, v.y, __fmul_rn(qx, v.x)));
  return __fmaf_rn(-2.0f, cross, v.w);
}

// smaller float <-> smaller unsigned; −0 counts as +0
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void nn_fused_prep_kernel(const float* __restrict__ t,
                                     const uint8_t* __restrict__ tmask, int64_t nt,
                                     int64_t padded, float4* __restrict__ packed,
                                     int64_t nq, unsigned long long* __restrict__ keys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < padded) {
    float4 v = make_float4(0.f, 0.f, 0.f, kBig);
    if (i < nt) {
      const float x = t[3 * i], y = t[3 * i + 1], z = t[3 * i + 2];
      const float sq = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
      v = make_float4(x, y, z, tmask[i] ? sq : kBig);
    }
    packed[i] = v;
  }
  if (i < nq) keys[i] = kNoKey;
}

// grid: (query tiles, target splits); split y scans tiles
// [y · tiles_per_split, (y + 1) · tiles_per_split) of the packed target.
__global__ void __launch_bounds__(kThreads)
nn_fused_main_kernel(const float* __restrict__ q, int64_t nq,
                     const float4* __restrict__ packed, int tiles, int tiles_per_split,
                     unsigned long long* __restrict__ keys) {
  __shared__ float4 ring[kStages][kTile];

  const int first = blockIdx.y * tiles_per_split;
  const int n_tiles = min(tiles_per_split, tiles - first);
  const float4* src = packed + (int64_t)first * kTile;

  float qx[kPer], qy[kPer], qz[kPer], best[kPer];
  int where[kPer];  // the first chunk of this split that reached `best`
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int64_t qi = (int64_t)blockIdx.x * kQueries + r * kThreads + threadIdx.x;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (qi < nq) {
      qx[r] = q[3 * qi];
      qy[r] = q[3 * qi + 1];
      qz[r] = q[3 * qi + 2];
    }
    best[r] = kBig;
    where[r] = -1;
  }

  // one commit a tile, empty past the last, so that a tile's group is always
  // the (kStages − 1)-th newest when its turn comes
  auto fetch = [&](int k) {
    if (k < n_tiles)
      for (int j = threadIdx.x; j < kTile; j += kThreads)
        cp_async16(&ring[k % kStages][j], src + (int64_t)k * kTile + j);
    cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) fetch(k);

  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile k has landed
    __syncthreads();               // every thread's part has, and tile k − 1 is done with
    fetch(k + kStages - 1);        // into the slot tile k − 1 has left
    const float4* tile = ring[k % kStages];
    for (int c = 0; c < kTile / kChunk; ++c) {
      float low[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) low[r] = best[r];
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) {
        const float4 v = tile[c * kChunk + j];
#pragma unroll
        for (int r = 0; r < kPer; ++r) low[r] = fminf(low[r], score_of(qx[r], qy[r], qz[r], v));
      }
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (low[r] < best[r]) {
          best[r] = low[r];
          where[r] = k * (kTile / kChunk) + c;
        }
    }
  }

#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int64_t qi = (int64_t)blockIdx.x * kQueries + r * kThreads + threadIdx.x;
    if (qi >= nq || where[r] < 0) continue;
    const float4* chunk = src + (int64_t)where[r] * kChunk;
    int at = kChunk - 1;
    for (int j = kChunk - 1; j >= 0; --j)
      if (score_of(qx[r], qy[r], qz[r], __ldg(chunk + j)) == best[r]) at = j;
    const unsigned index = (unsigned)(((int64_t)first * kTile) + (int64_t)where[r] * kChunk + at);
    atomicMin(keys + qi, ((unsigned long long)ordered_bits(best[r]) << 32) | index);
  }
}

__global__ void nn_fused_finish_kernel(const unsigned long long* __restrict__ keys,
                                       int64_t nq, int32_t* __restrict__ out_idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nq) out_idx[i] = keys[i] == kNoKey ? 0 : (int32_t)(keys[i] & 0xffffffffull);
}

// ---- the first design ------------------------------------------------------

constexpr int kTQ = 256;
constexpr int kTT = 2048;

__global__ void __launch_bounds__(kTQ)
nn_fused_v1_kernel(const float* __restrict__ q, int64_t nq,
                   const float* __restrict__ t, const uint8_t* __restrict__ tmask,
                   int64_t nt, float* __restrict__ out_val,
                   int32_t* __restrict__ out_idx) {
  __shared__ float4 tile[kTT];

  const int64_t qi = (int64_t)blockIdx.x * kTQ + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < nq) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  float best = kBig;
  int32_t best_j = 0;

  for (int64_t base = 0; base < nt; base += kTT) {
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < kTT; k += kTQ) {
      const int64_t g = base + k;
      float4 v = make_float4(0.f, 0.f, 0.f, kBig);
      if (g < nt) {
        const float x = t[3 * g], y = t[3 * g + 1], z = t[3 * g + 2];
        const float sq = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
        v = make_float4(x, y, z, tmask[g] ? sq : kBig);
      }
      tile[k] = v;
    }
    __syncthreads();
    const int n_here = (int)min((int64_t)kTT, nt - base);
    for (int k = 0; k < n_here; ++k) {
      const float score = score_of(qx, qy, qz, tile[k]);
      if (score < best) {
        best = score;
        best_j = (int32_t)(base + k);
      }
    }
  }
  if (qi < nq) {
    out_val[qi] = best;
    out_idx[qi] = best_j;
  }
}

}  // namespace

extern "C" {

// The target splits of the main kernel's grid for nq queries and nt targets
// (−1 on an error).  `splits` > 0 is the caller's wish; 0 asks for enough
// blocks for about four rounds of the card's resident blocks, every split at
// least four tiles (a split pays once for filling its ring, for its second
// look at a chunk and for a key a query).  Either is cut to the tiles there are and evened out so
// that no split is empty.
int pctpu_nn_fused_splits(int64_t nq, int64_t nt, int splits) {
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_fused_main_kernel, kThreads,
                                                      0) != cudaSuccess)
      return -1;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = (nt + kTile - 1) / kTile;
  const int64_t q_tiles = (nq + kQueries - 1) / kQueries;
  if (nq <= 0 || nt <= 0 || tiles > 0x7fffffff / kTile || q_tiles > 0x7fffffff) return -1;
  int64_t want = splits;
  if (want <= 0) {
    want = (4 * (int64_t)resident + q_tiles - 1) / q_tiles;
    if (want > tiles / 4) want = tiles / 4;
  }
  if (want > tiles) want = tiles;
  if (want > 65535) want = 65535;
  if (want < 1) want = 1;
  const int64_t per_split = (tiles + want - 1) / want;
  return (int)((tiles + per_split - 1) / per_split);
}

// packed: scratch of ⌈nt / 512⌉ · 512 float4; keys: scratch of nq 64-bit
// words; `splits` as pctpu_nn_fused_splits takes it.  Returns the first error
// of the three launches: a launch the card refuses never runs, and a later
// synchronize would not report it.
int pctpu_nn_fused(const float* q, int64_t nq, const float* t, const uint8_t* tmask,
                   int64_t nt, float* packed, unsigned long long* keys, int32_t* out_idx,
                   int splits, void* stream) {
  splits = pctpu_nn_fused_splits(nq, nt, splits);
  if (splits <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = (nt + kTile - 1) / kTile;
  const int64_t q_tiles = (nq + kQueries - 1) / kQueries;
  const int tiles_per_split = (int)((tiles + splits - 1) / splits);

  const int64_t most = tiles * kTile > nq ? tiles * kTile : nq;
  nn_fused_prep_kernel<<<(unsigned)((most + 255) / 256), 256, 0, st>>>(
      t, tmask, nt, tiles * kTile, reinterpret_cast<float4*>(packed), nq, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_fused_main_kernel<<<dim3((unsigned)q_tiles, (unsigned)splits), kThreads, 0, st>>>(
      q, nq, reinterpret_cast<const float4*>(packed), (int)tiles, tiles_per_split, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_fused_finish_kernel<<<(unsigned)((nq + 255) / 256), 256, 0, st>>>(keys, nq, out_idx);
  return (int)cudaGetLastError();
}

// The first design: one launch.
int pctpu_nn_fused_v1(const float* q, int64_t nq, const float* t, const uint8_t* tmask,
                      int64_t nt, float* out_val, int32_t* out_idx, void* stream) {
  if (nq <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (nq + kTQ - 1) / kTQ;
  nn_fused_v1_kernel<<<(unsigned)blocks, kTQ, 0, (cudaStream_t)stream>>>(
      q, nq, t, tmask, nt, out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
