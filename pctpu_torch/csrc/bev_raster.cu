// Hand-written Hopper kernels of the BEV slice, built by nvcc with the other
// csrc/*.cu sources into one shared library (pctpu_torch/ops/_cuda.py).
//
// The fused multi-layer occupancy + single-layer height BEV of
// batch_multi_bev_gen (pctpu/ops/bev.py:95 fused_multi_single_bev, the
// reference's BatchMultiBevGen.cpp:261-373).  It replaces no Pallas kernel:
// pctpu builds both rasters on the TPU with two key sorts and a
// Hillis-Steele OR scan, because a TPU scatter is slow; Hopper has fast
// global atomics instead.
//
// What bounds it on the card: bytes.  A batch of eight HDL-64E clouds reads
// 16 B a point (xyz and the label, 17 MB) and writes 25 rasters of 224² bytes
// a cloud (10 MB): ≈ 8 µs at the memory's rate.  Next to that bound stand
// what each launch costs (≈ 2 µs on the card) and what the atomics cost:
// neighbouring azimuths of one ring fall into the same cell, so most of a
// warp's atomics hit a few words and wait for one another.  The design keeps
// launches few, combines equal cells before the atomics and writes wide:
//
// pctpu_bev_raster, one C call = one memset + two kernels on the stream:
//   the memset zeroes the scratch, (B, 2, S²) words — for every cell an
//     occupancy word and a height word.  Two separate words a cell: a single
//     word with atomicOr + atomicMax would let the occupancy bits of other
//     points decide the max of the height byte.  A scratch zeroed by the call
//     itself (and not kept clean across calls by the expand kernel) is safe
//     under any number of streams and after a failed call, for 1.7 µs;
//   bev_raster_kernel: blockIdx.y is the cloud (no division), a thread takes
//     one of its points; a block past the cloud's count leaves at once, and a
//     thread reads its label first and the xyz of a valid non-ground point
//     only.  The lanes of a warp that hit one cell find each other with
//     __match_any_sync, reduce their layer bits (OR) and heights (max) in the
//     warp, and the lowest lane does the group's atomicMax into the cell's
//     height word and atomicOr into its occupancy word: 96,018 atomics where
//     one a point sends 585,833 on the path's batch.  OR and max are
//     commutative and associative, so neither the grouping nor the order of
//     the atomics can change the result.  (An atomic pair a point took 17.0
//     µs where this takes 10.5 on an H100.  Staging a block's contiguous xyz
//     through shared memory with 16-byte loads was measured and is not kept:
//     the barrier cost more than the narrow loads, 13.2 against 10.5 µs on an
//     H100.)
//   bev_expand_kernel: a thread owns 16 consecutive cells of one cloud, reads
//     their words with eight 16-byte loads and writes one 16-byte streaming
//     store a layer (a warp covers 512 contiguous bytes a store) and one for
//     the height raster; nothing on the card reads the rasters again before
//     they are copied to the host.  When S² is no multiple of 16 the rows of
//     the rasters are not 16-byte aligned, and the same threads write bytes.
//
// The first design's kernels (one thread a point over the whole batch with a
// 64-bit division and two atomics a point; one thread a cell writing 25
// single bytes; two scratch tensors zeroed by the wrapper) stay below as
// pctpu_bev_raster_v1, so that old, new and twin can be held and timed in
// one call.
//
// The index arithmetic is pctpu's, written with __f*_rn intrinsics so nvcc
// contracts nothing, and with cvt.rzi (saturating, NaN -> 0) for every
// f32 -> int32, which is XLA's astype(int32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerThread = 16;

__device__ __forceinline__ int f2i(float v) { return __float2int_rz(v); }

// round((coord + range) / interval + 0.5) with the 0.5 in f64
// (pctpu/ops/rounding.py:47-55)
__device__ __forceinline__ int bev_cell(float coord, float range, float interval) {
  const float t = __fdiv_rn(__fadd_rn(coord, range), interval);
  // unsigned add: floor(t) + 1 wraps at INT_MAX like XLA's int32 add
  return t >= -0.5f ? (int)((unsigned)f2i(floorf(t)) + 1u) : f2i(ceilf(t));
}

// C round(): half away from zero (pctpu/ops/rounding.py:34-40)
__device__ __forceinline__ float c_round(float v) {
  const float a = fabsf(v);
  const float k = floorf(a);
  const float r = __fadd_rn(k, __fsub_rn(a, k) >= 0.5f ? 1.0f : 0.0f);
  return v < 0.0f ? -r : r;
}

struct Grid {
  int s, nl;
  float range, interval, height_res, layer_offset, height_offset, height_scale;
};

// A point's cell in its cloud's raster (-1 outside the grid), its height
// byte and its occupancy bit (0 when the layer is out of range).
__device__ __forceinline__ int bev_point(float x, float y, float z, const Grid& g,
                                         int* height, unsigned* bit) {
  const int cx = bev_cell(x, g.range, g.interval);
  const int cy = bev_cell(y, g.range, g.interval);
  if (cx < 0 || cx >= g.s || cy < 0 || cy >= g.s) return -1;
  const int h = f2i(truncf(__fmul_rn(__fadd_rn(z, g.height_offset), g.height_scale)));
  *height = min(max(h, 0), 255);
  const int layer = f2i(c_round(__fadd_rn(__fdiv_rn(z, g.height_res), g.layer_offset)));
  *bit = layer >= 0 && layer < g.nl ? 1u << layer : 0u;
  return cx * g.s + cy;
}

// words: (B, 2, S²) — [cloud][0] occupancy bits, [cloud][1] heights; zero on
// entry.  With `counter` the kernel also counts the atomics it sends.
__global__ void __launch_bounds__(kThreads)
bev_raster_kernel(const float* __restrict__ xyz, const int32_t* __restrict__ label,
                  const int64_t* __restrict__ count, int64_t p, Grid g,
                  unsigned* __restrict__ words, unsigned long long* __restrict__ counter) {
  const int64_t cloud = blockIdx.y;
  const int64_t n = min(count[cloud], p);
  if ((int64_t)blockIdx.x * kThreads >= n) return;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int height = 0;
  unsigned bit = 0;
  int cell = -1;
  if (i < n && label[cloud * p + i] != 0) {
    const float* at = xyz + 3 * (cloud * p + i);
    cell = bev_point(at[0], at[1], at[2], g, &height, &bit);
  }
  // every lane of the warp is here: a block leaves only as a whole
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  if (cell < 0) return;
  bit = __reduce_or_sync(peers, bit);
  height = __reduce_max_sync(peers, height);
  if ((threadIdx.x & 31) != __ffs(peers) - 1) return;
  const int64_t cells = (int64_t)g.s * g.s;
  unsigned* occ = words + cloud * 2 * cells + cell;
  if (height > 0) atomicMax(reinterpret_cast<int*>(occ + cells), height);
  if (bit) atomicOr(occ, bit);
  if (counter) atomicAdd(counter, (unsigned long long)((height > 0) + (bit != 0)));
}

// 0 / 255 bytes of four cells' bit `l`, cell k in byte k
__device__ __forceinline__ unsigned layer_bytes(const uint4& o, int l) {
  const unsigned b = ((o.x >> l) & 1u) | (((o.y >> l) & 1u) << 8) |
                     (((o.z >> l) & 1u) << 16) | (((o.w >> l) & 1u) << 24);
  return b * 255u;
}

__device__ __forceinline__ unsigned low_bytes(const uint4& h) {
  return (h.x & 255u) | ((h.y & 255u) << 8) | ((h.z & 255u) << 16) | (h.w << 24);
}

__global__ void __launch_bounds__(kThreads)
bev_expand_kernel(const unsigned* __restrict__ words, int s, int nl,
                  uint8_t* __restrict__ multi, uint8_t* __restrict__ single) {
  const int64_t cells = (int64_t)s * s;
  const int64_t cloud = blockIdx.y;
  const int64_t cell0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kCellsPerThread;
  if (cell0 >= cells) return;
  const unsigned* occ = words + cloud * 2 * cells + cell0;
  const unsigned* hgt = occ + cells;
  uint8_t* out = multi + cloud * nl * cells + cell0;
  uint8_t* low = single + cloud * cells + cell0;

  if ((cells & (kCellsPerThread - 1)) == 0) {
    // every row of both rasters and of the words starts 16-byte aligned
    uint4 o[4], h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = __ldg(reinterpret_cast<const uint4*>(occ) + k);
      h[k] = __ldg(reinterpret_cast<const uint4*>(hgt) + k);
    }
#pragma unroll 8
    for (int l = 0; l < nl; ++l)
      __stcs(reinterpret_cast<uint4*>(out + l * cells),
             make_uint4(layer_bytes(o[0], l), layer_bytes(o[1], l), layer_bytes(o[2], l),
                        layer_bytes(o[3], l)));
    __stcs(reinterpret_cast<uint4*>(low),
           make_uint4(low_bytes(h[0]), low_bytes(h[1]), low_bytes(h[2]), low_bytes(h[3])));
    return;
  }
  const int here = (int)min((int64_t)kCellsPerThread, cells - cell0);
  for (int k = 0; k < here; ++k) {
    const unsigned bits = occ[k];
    for (int l = 0; l < nl; ++l) out[l * cells + k] = (bits >> l) & 1u ? 255 : 0;
    low[k] = (uint8_t)hgt[k];
  }
}

// ---- the first design ------------------------------------------------------

__global__ void bev_raster_v1_kernel(const float* __restrict__ xyz,
                                     const int32_t* __restrict__ label,
                                     const int64_t* __restrict__ count, int64_t b,
                                     int64_t p, Grid g, unsigned* __restrict__ occ,
                                     int* __restrict__ hgt,
                                     unsigned long long* __restrict__ counter) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= b * p) return;
  const int64_t cloud = i / p;
  if (i - cloud * p >= count[cloud] || label[i] == 0) return;
  int height = 0;
  unsigned bit = 0;
  const int in_cloud = bev_point(xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2], g, &height, &bit);
  if (in_cloud < 0) return;
  const int64_t cell = cloud * (int64_t)g.s * g.s + in_cloud;
  if (height > 0) atomicMax(&hgt[cell], height);
  if (bit) atomicOr(&occ[cell], bit);
  if (counter) atomicAdd(counter, (unsigned long long)((height > 0) + (bit != 0)));
}

__global__ void bev_expand_v1_kernel(const unsigned* __restrict__ occ,
                                     const int* __restrict__ hgt, int64_t b, int s,
                                     int nl, uint8_t* __restrict__ multi,
                                     uint8_t* __restrict__ single) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t cells = (int64_t)s * s;
  if (i >= b * cells) return;
  const int64_t cloud = i / cells, cell = i - cloud * cells;
  const unsigned bits = occ[i];
  uint8_t* out = multi + cloud * nl * cells + cell;
  for (int l = 0; l < nl; ++l) out[l * cells] = (bits >> l) & 1u ? 255 : 0;
  single[i] = (uint8_t)hgt[i];
}

bool grid_ok(int64_t b, int64_t p, int s, int nl) {
  return b > 0 && b <= 65535 && p > 0 && s > 0 && nl > 0 && nl <= 32;
}

}  // namespace

extern "C" {

// words: scratch of b * 2 * s * s int32, in any state on entry.  `counter`,
// when not null, points at a zeroed counter of the atomics the raster kernel
// sends.  Returns the first error of the memset and the two launches.
int pctpu_bev_raster(const float* xyz, const int32_t* label, const int64_t* count,
                     int64_t b, int64_t p, int s, int nl, float range, float interval,
                     float height_res, float layer_offset, float height_offset,
                     float height_scale, int* words, uint8_t* multi, uint8_t* single,
                     unsigned long long* counter, void* stream) {
  if (!grid_ok(b, p, s, nl)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Grid g{s, nl, range, interval, height_res, layer_offset, height_offset, height_scale};
  const int64_t cells = (int64_t)s * s;
  cudaError_t err = cudaMemsetAsync(words, 0, (size_t)(b * 2 * cells) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 points((unsigned)((p + kThreads - 1) / kThreads), (unsigned)b);
  bev_raster_kernel<<<points, kThreads, 0, st>>>(xyz, label, count, p, g,
                                                 reinterpret_cast<unsigned*>(words), counter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t per_block = (int64_t)kThreads * kCellsPerThread;
  const dim3 cell_blocks((unsigned)((cells + per_block - 1) / per_block), (unsigned)b);
  bev_expand_kernel<<<cell_blocks, kThreads, 0, st>>>(
      reinterpret_cast<const unsigned*>(words), s, nl, multi, single);
  return (int)cudaGetLastError();
}

// The first design.  occ and hgt (b * s * s int32 each) must be zero on entry.
int pctpu_bev_raster_v1(const float* xyz, const int32_t* label, const int64_t* count,
                        int64_t b, int64_t p, int s, int nl, float range, float interval,
                        float height_res, float layer_offset, float height_offset,
                        float height_scale, int* occ, int* hgt, uint8_t* multi,
                        uint8_t* single, unsigned long long* counter, void* stream) {
  if (!grid_ok(b, p, s, nl)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Grid g{s, nl, range, interval, height_res, layer_offset, height_offset, height_scale};
  bev_raster_v1_kernel<<<(unsigned)((b * p + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      xyz, label, count, b, p, g, reinterpret_cast<unsigned*>(occ), hgt, counter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = b * (int64_t)s * s;
  bev_expand_v1_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      reinterpret_cast<const unsigned*>(occ), hgt, b, s, nl, multi, single);
  return (int)cudaGetLastError();
}

}  // extern "C"
