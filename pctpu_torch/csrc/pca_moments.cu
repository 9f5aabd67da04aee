// Hand-written Hopper kernel of pointcloud_pca_test's moments, built by nvcc
// with the other sources of csrc/ into one shared library with a plain C
// interface (pctpu_torch/ops/_cuda.py) and launched through ctypes on
// PyTorch's current stream.
//
// Replaces no Pallas kernel: it takes the place of the XLA reduce and dot of
// pctpu/ops/pca.py:40-43 (pca3d's masked mean and normalised covariance),
// because LAPACK picks the eigenvectors' signs from the covariance's last
// bits, and neither torch.matmul nor cuBLAS nor any torch sum keeps pctpu's
// order.
//
// Contract (pca.pca_moments, bit-equal to its twin pca_moments_reference):
// n rows of f32 (x, y, z) and a bool mask, w = mask as 0/1.
//   count = max(Σw, 1) (exact: integers below 2**24).
//   mean  = XLA's CPU tree of xyz·w: windows of 32 rows summed in order
//           from +0 (the padding ceil(n/32)·32 − n split low = half, padded
//           rows skipped), the window sums again in windows of 32, until at
//           most 32 are left, which are summed in order from +0; one row is
//           its own sum.  Then ÷ count.
//   cov   = for each (i, j) the chain acc = fma(d_k[i], d_k[j], acc) over
//           k = 0 … n−1 from +0 (one row: its own product), d = (xyz −
//           mean)·w, then ÷ count.  (i, j) and (j, i) are the same chain:
//           six chains are computed and mirrored.
// Every product and sum is a separately rounded f32 operation (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn: nvcc may not contract them) except the
// chain's fma, which is fused, as XLA's LLVM contracts the dot's loop.
//
// A row whose d is (±0, ±0, ±0) adds an exact ±0 to every chain, which
// leaves a chain from +0 as it was (it is never −0), so only the live rows
// — some d_k[i] ≠ 0, NaN included — need their fmas; one row (n = 1) is
// always taken, since its chain starts from −0.
//
// What bounds it on the card: not the bytes (13 B a row, ≈ 0.5 µs at a
// cloud's 133,312 rows) but the contract's one serial cost, the mean's tree
// (32 adds a level on its critical path) and then one chain of an fma a live
// row, 4 cycles each (the filtered demo cloud keeps ≈ 5% of its rows: ≈ 7,100
// fmas, ≈ 0.015 ms at 1,980 MHz).  So everything but the chain runs over the
// whole card, and the chain reads only live rows from shared memory.  Three
// launches:
//   - pca_windows_kernel, the mean's first level (n > 32 only): a block of
//     192 threads takes 64 windows, reads their 2,048 rows coalesced into
//     shared memory (x·w, y·w, z·w as three arrays, a pad word every 32 so
//     that the window sums read without bank conflicts), one thread a
//     (window, lane) adds the window's 32 rows, and the block writes its
//     count of masked-in rows;
//   - pca_live_kernel, a block of 16 warps a tile of 4,096 rows: each block
//     issues its rows' loads, sums the count, takes the mean's next levels
//     from the first level's sums in shared memory (every block the same,
//     bit for bit; block 0 writes the mean out), then computes d for its
//     tile and writes the tile's live rows, in row order, to its slice of
//     three device-memory columns: a ballot a step of 32 rows, the warps'
//     counts summed in warp order, a popc of the lower lanes' ballot bits
//     for a row's place;
//   - pca_chain_kernel, one block of 17 warps: the tiles' live counts summed
//     into offsets, then the live rows pass in chunks of 2,048 through
//     shared memory (x, y and z as three arrays, two buffers, 48 KB): while
//     lanes 0-5 of warp 0 run their chains over one chunk (16-byte shared
//     loads issued four groups ahead of their fmas), the other 16 warps
//     gather the next chunk's rows from the tiles' slices.  A chain step
//     waits only for the fma before it.
// The first design ran all but the mean's first level in one block, a thread
// a window reading device memory, the chains over every row with their loads
// beside their fmas: 0.76 ms at 133,312 rows (H100, 700 W); the second (one
// block for the mean's last levels and the chains over every row, four
// groups ahead) 0.40 ms; a third (one block computing d and the live rows
// tile by tile beside the chains) was held back by that one block's loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;
constexpr int kLevelWindows = 64;  // first-level windows a block of pca_windows_kernel
constexpr int kLevelRows = kLevelWindows * kWindow;
constexpr int kLevelThreads = 3 * kLevelWindows;
constexpr int kWarps = 16;  // the live kernel's warps; the chain kernel's gathering warps
constexpr int kSteps = 8;  // rows a live-kernel lane takes, 32 apart
constexpr int kTile = kWarps * 32 * kSteps;  // rows a live-kernel block takes
constexpr int kLiveThreads = 32 * kWarps;
constexpr int kChainThreads = 32 * (1 + kWarps);  // warp 0 runs the chains
constexpr int kChunk = 2048;  // live rows a shared buffer of the chain kernel holds
constexpr int kChainSmem = 2 * 3 * kChunk * static_cast<int>(sizeof(float));
constexpr int64_t kMaxRows = int64_t{1} << 24;  // the count is exact in f32 below this
constexpr int kMaxTiles = static_cast<int>(kMaxRows / kTile);
// the mean's second level: at most 2**24 / 32 / 32 windows of 3 floats
constexpr int kMaxLevel2 = static_cast<int>(kMaxRows / kWindow / kWindow);
constexpr int kMaxLevel3 = kMaxLevel2 / kWindow;
constexpr int kStage = 4;  // float4 groups of a chain loaded ahead of their fmas

__device__ __forceinline__ float weight(const uint8_t* __restrict__ mask, int64_t r) {
  return mask[r] ? 1.0f : 0.0f;
}

// xyz·w of row r, lane c, as XLA's separate multiply rounds it
__device__ __forceinline__ float weighted(const float* __restrict__ xyz,
                                          const uint8_t* __restrict__ mask, int64_t r, int c) {
  return __fmul_rn(xyz[3 * r + c], weight(mask, r));
}

// acc = fma(x[k], y[k], acc) over the 4·groups rows of two shared-memory
// columns, in order.  The loads of the next kStage groups are issued before
// the fmas of the current ones, so that an fma waits only for the one before
// it, not for shared memory.
__device__ __forceinline__ float chain(float acc, const float4* __restrict__ x,
                                       const float4* __restrict__ y, int groups) {
  float4 a[kStage], b[kStage];
  int g = 0;
  if (groups >= kStage) {
#pragma unroll
    for (int u = 0; u < kStage; ++u) a[u] = x[u], b[u] = y[u];
    for (g = kStage; g + kStage <= groups; g += kStage) {
      float4 na[kStage], nb[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) na[u] = x[g + u], nb[u] = y[g + u];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        acc = __fmaf_rn(a[u].x, b[u].x, acc);
        acc = __fmaf_rn(a[u].y, b[u].y, acc);
        acc = __fmaf_rn(a[u].z, b[u].z, acc);
        acc = __fmaf_rn(a[u].w, b[u].w, acc);
        a[u] = na[u];
        b[u] = nb[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      acc = __fmaf_rn(a[u].x, b[u].x, acc);
      acc = __fmaf_rn(a[u].y, b[u].y, acc);
      acc = __fmaf_rn(a[u].z, b[u].z, acc);
      acc = __fmaf_rn(a[u].w, b[u].w, acc);
    }
  }
  for (; g < groups; ++g) {
    const float4 p = x[g], q = y[g];
    acc = __fmaf_rn(p.x, q.x, acc);
    acc = __fmaf_rn(p.y, q.y, acc);
    acc = __fmaf_rn(p.z, q.z, acc);
    acc = __fmaf_rn(p.w, q.w, acc);
  }
  return acc;
}

// the padded shared-memory slot of a block's row r: one pad word every 32
__device__ __forceinline__ int padded(int r) { return r + r / kWindow; }

// Where the scratch words go (pctpu_pca_moments_scratch_words): the first
// level's window sums, the first kernel's block counts, the tiles' live
// counts, the count, and the live rows' three columns, a tile's slice each.
struct Sizes {
  int64_t windows, blocks, tiles;
  __host__ __device__ explicit Sizes(int64_t n)
      : windows((n + kWindow - 1) / kWindow),
        blocks((windows + kLevelWindows - 1) / kLevelWindows),
        tiles(n > 0 ? (n + kTile - 1) / kTile : 1) {}
  __host__ __device__ int64_t words() const {
    return 3 * windows + blocks + tiles + 1 + 3 * tiles * kTile;
  }
};

struct Scratch : Sizes {
  float* sums;
  int* block_counts;
  int* live_counts;
  float* count;
  float* cols;
  __host__ __device__ Scratch(float* base, int64_t n) : Sizes(n) {
    sums = base;
    block_counts = reinterpret_cast<int*>(base + 3 * windows);
    live_counts = block_counts + blocks;
    count = reinterpret_cast<float*>(live_counts + tiles);
    cols = count + 1;
  }
};

// The mean's first level: the sum of each window of 32 rows of xyz·w (rows
// before 0 or past n, the padding, add nothing), window-major, 3 floats a
// window; and each block's count of masked-in rows.
__global__ void __launch_bounds__(kLevelThreads)
    pca_windows_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                       int64_t n, int64_t low, int64_t windows, float* __restrict__ sums,
                       int* __restrict__ counts) {
  __shared__ float rows[3][kLevelRows + kLevelRows / kWindow];
  __shared__ int s_ones;
  const int tid = threadIdx.x;
  if (tid == 0) s_ones = 0;
  const int64_t first = blockIdx.x * static_cast<int64_t>(kLevelRows) - low;
  int ones = 0;
#pragma unroll
  for (int i = 0; i < 3 * kLevelRows / kLevelThreads; ++i) {
    const int f = tid + i * kLevelThreads;
    const int64_t r = first + f / 3;
    const bool in = r >= 0 && r < n;
    ones += in && f % 3 == 0 && mask[r];
    // a padded row is +0, which leaves a sum from +0 as it was
    rows[f % 3][padded(f / 3)] = in ? __fmul_rn(xyz[3 * first + f], weight(mask, r)) : 0.0f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ones += __shfl_xor_sync(kFull, ones, o);
  __syncthreads();
  if ((tid & 31) == 0) atomicAdd(&s_ones, ones);
  const int lane = tid / kLevelWindows, w = tid % kLevelWindows;
  const int64_t window = blockIdx.x * static_cast<int64_t>(kLevelWindows) + w;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kWindow; ++k) acc = __fadd_rn(acc, rows[lane][padded(w * kWindow + k)]);
  if (window < windows) sums[3 * window + lane] = acc;
  __syncthreads();
  if (tid == 0) counts[blockIdx.x] = s_ones;
}

__global__ void __launch_bounds__(kLiveThreads)
    pca_live_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask, int64_t n,
                    float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float level2[];  // the mean's second level, 3 floats a window
  __shared__ float level3[3 * kMaxLevel3];
  __shared__ float s_mu[3];
  __shared__ int s_n;
  __shared__ int s_cnt[kWarps];
  const Scratch sc(scratch, n);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // this block's rows, loaded first so that they are in flight during the mean
  const int64_t first = blockIdx.x * static_cast<int64_t>(kTile) + warp * (32 * kSteps) + lane;
  float d[kSteps][3];
  bool m[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t r = first + 32 * s;
    const bool in = r < n;
    m[s] = in && mask[r];
#pragma unroll
    for (int c = 0; c < 3; ++c) d[s][c] = in ? xyz[3 * r + c] : 0.0f;
  }

  // the count: the first kernel's block counts, or the ≤ 32 rows
  if (tid == 0) s_n = 0;
  __syncthreads();
  int ones = 0;
  if (n > kWindow) {
    for (int64_t i = tid; i < sc.blocks; i += kLiveThreads) ones += sc.block_counts[i];
  } else if (tid < n) {
    ones = mask[tid] != 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ones += __shfl_xor_sync(kFull, ones, o);
  if (lane == 0) atomicAdd(&s_n, ones);

  // the mean's tree from the first level's sums, the same in every block:
  // the second level into level2, the third into level3, a fourth (≤ 16
  // windows) into level2 again
  const float* src = n > kWindow ? sc.sums : nullptr;  // null: the weighted rows
  int64_t size = n > kWindow ? sc.windows : n;
  for (int lvl = 0; size > kWindow; ++lvl) {
    const int64_t outs = (size + kWindow - 1) / kWindow;
    const int64_t low = (outs * kWindow - size) / 2;
    float* dst = lvl % 2 == 0 ? level2 : level3;
    for (int64_t w = tid; w < outs; w += kLiveThreads) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      const int64_t start = w * kWindow - low;
      // a padded row is +0, which leaves a sum from +0 as it was
#pragma unroll
      for (int k = 0; k < kWindow; ++k) {
        const int64_t r = start + k;
        const bool in = r >= 0 && r < size;
        a0 = __fadd_rn(a0, in ? src[3 * r] : 0.0f);
        a1 = __fadd_rn(a1, in ? src[3 * r + 1] : 0.0f);
        a2 = __fadd_rn(a2, in ? src[3 * r + 2] : 0.0f);
      }
      dst[3 * w] = a0;
      dst[3 * w + 1] = a1;
      dst[3 * w + 2] = a2;
    }
    __syncthreads();
    src = dst;
    size = outs;
  }
  __syncthreads();
  if (tid == 0) {
    // −0 + x = x for every x: one row is its own sum
    float a[3] = {n == 1 ? -0.0f : 0.0f, n == 1 ? -0.0f : 0.0f, n == 1 ? -0.0f : 0.0f};
    for (int64_t r = 0; r < size; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        a[c] = __fadd_rn(a[c], src == nullptr ? weighted(xyz, mask, r, c) : src[3 * r + c]);
    }
    const float count = fmaxf(static_cast<float>(s_n), 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) s_mu[c] = __fdiv_rn(a[c], count);
    if (blockIdx.x == 0) {
      *sc.count = count;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = s_mu[c];
    }
  }
  __syncthreads();

  // d and the live rows of this tile (module comment)
  const float mu0 = s_mu[0], mu1 = s_mu[1], mu2 = s_mu[2];
  unsigned live[kSteps];
  int total = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float w = m[s] ? 1.0f : 0.0f;
    d[s][0] = __fmul_rn(__fsub_rn(d[s][0], mu0), w);
    d[s][1] = __fmul_rn(__fsub_rn(d[s][1], mu1), w);
    d[s][2] = __fmul_rn(__fsub_rn(d[s][2], mu2), w);
    // NaN ≠ 0: a NaN row is live
    const bool keep = first + 32 * s < n &&
                      (n == 1 || d[s][0] != 0.0f || d[s][1] != 0.0f || d[s][2] != 0.0f);
    live[s] = __ballot_sync(kFull, keep);
    total += __popc(live[s]);
  }
  if (lane == 0) s_cnt[warp] = total;
  __syncthreads();
  int at = 0;
  for (int g = 0; g < warp; ++g) at += s_cnt[g];
  if (tid == 0) {
    int all = 0;
    for (int g = 0; g < kWarps; ++g) all += s_cnt[g];
    sc.live_counts[blockIdx.x] = all;
  }
  const int64_t stride = sc.tiles * kTile;
  float* col = sc.cols + blockIdx.x * static_cast<int64_t>(kTile);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (live[s] >> lane & 1u) {
      const int p = at + __popc(live[s] & below);
      col[p] = d[s][0];
      col[stride + p] = d[s][1];
      col[2 * stride + p] = d[s][2];
    }
    at += __popc(live[s]);
  }
}

// Gathering thread g's share of live rows [begin, end) into the buffer b (x,
// y, z columns kChunk apart): live row q is row q − off[t] of tile t's slice,
// off[t] ≤ q < off[t + 1].
__device__ __forceinline__ void gather(const Scratch& sc, const int* off, int64_t begin,
                                       int64_t end, float* b, int g) {
  constexpr int kPer = kChunk / (32 * kWarps);
  const int64_t stride = sc.tiles * kTile;
  int64_t src[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t q = begin + k * (32 * kWarps) + g;
    int lo = 0, hi = static_cast<int>(sc.tiles);  // off[lo] ≤ q < off[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (off[mid] <= q) lo = mid;
      else hi = mid;
    }
    src[k] = q < end ? lo * static_cast<int64_t>(kTile) + (q - off[lo]) : -1;
  }
  float v[kPer][3];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) v[k][c] = src[k] >= 0 ? sc.cols[c * stride + src[k]] : 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (src[k] < 0) continue;
    const int p = k * (32 * kWarps) + g;
#pragma unroll
    for (int c = 0; c < 3; ++c) b[c * kChunk + p] = v[k][c];
  }
}

__global__ void __launch_bounds__(kChainThreads, 1)
    pca_chain_kernel(int64_t n, float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);
  __shared__ int off[kMaxTiles + 1];
  const Scratch sc(scratch, n);
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  if (tid == 0) {
    int at = 0;
    for (int64_t t = 0; t < sc.tiles; ++t) {
      off[t] = at;
      at += sc.live_counts[t];
    }
    off[sc.tiles] = at;
  }
  __syncthreads();
  const int64_t rows = off[sc.tiles];
  const int64_t chunks = (rows + kChunk - 1) / kChunk;
  if (warp > 0 && chunks > 0) gather(sc, off, 0, rows < kChunk ? rows : kChunk, bufs, tid - 32);
  __syncthreads();
  // lane e of warp 0 runs chain e over (i, j) = (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
  const int pi = tid < 3 ? 0 : tid < 5 ? 1 : 2;
  const int pj = tid < 3 ? tid : tid < 5 ? tid - 2 : 2;
  float acc = n == 1 ? -0.0f : 0.0f;
  for (int64_t c = 0; c < chunks; ++c) {
    if (warp > 0) {
      const int64_t next = (c + 1) * kChunk;
      if (next < rows)
        gather(sc, off, next, rows < next + kChunk ? rows : next + kChunk,
               bufs + ((c + 1) & 1) * 3 * kChunk, tid - 32);
    } else if (tid < 6) {
      const int k_rows = static_cast<int>(rows - c * kChunk < kChunk ? rows - c * kChunk : kChunk);
      const float* b = bufs + (c & 1) * 3 * kChunk;
      const float* bi = b + pi * kChunk;
      const float* bj = b + pj * kChunk;
      acc = chain(acc, reinterpret_cast<const float4*>(bi), reinterpret_cast<const float4*>(bj),
                  k_rows / 4);
      for (int k = k_rows & ~3; k < k_rows; ++k) acc = __fmaf_rn(bi[k], bj[k], acc);
    }
    __syncthreads();
  }
  if (tid < 6) {
    const float v = __fdiv_rn(acc, *sc.count);
    out[3 + 3 * pi + pj] = v;
    out[3 + 3 * pj + pi] = v;
  }
}

}  // namespace

extern "C" {

// The 4-byte words of scratch pctpu_pca_moments takes for n rows.
int64_t pctpu_pca_moments_scratch_words(int64_t n) { return Sizes(n).words(); }

// Returns cudaGetLastError() right after the launches.  xyz: n < 2**24 rows
// of 3 floats; mask: n bytes (torch.bool); scratch:
// pctpu_pca_moments_scratch_words(n) words; out: 12 floats, the mean then
// the row-major covariance.
int pctpu_pca_moments(const float* xyz, const uint8_t* mask, int64_t n, float* scratch,
                      float* out, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        pca_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChainSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(pca_live_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               3 * kMaxLevel2 * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (n < 0 || n >= kMaxRows) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc(scratch, n);
  if (n > kWindow) {
    const int64_t low = (sc.windows * kWindow - n) / 2;
    pca_windows_kernel<<<static_cast<unsigned>(sc.blocks), kLevelThreads, 0, s>>>(
        xyz, mask, n, low, sc.windows, sc.sums, sc.block_counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t level2 = (sc.windows + kWindow - 1) / kWindow;
  const size_t smem = static_cast<size_t>(3 * (level2 > 0 ? level2 : 1)) * sizeof(float);
  pca_live_kernel<<<static_cast<unsigned>(sc.tiles), kLiveThreads, smem, s>>>(xyz, mask, n,
                                                                              scratch, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pca_chain_kernel<<<1, kChainThreads, kChainSmem, s>>>(n, scratch, out);
  return cudaGetLastError();
}

}  // extern "C"
