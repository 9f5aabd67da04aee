// Hand-written Hopper kernels of the BEV slice, built by nvcc with the other
// csrc/*.cu sources into one shared library (pctpu_torch/ops/_cuda.py).
//
// The fused multi-layer occupancy + single-layer height BEV of
// batch_multi_bev_gen (pctpu/ops/bev.py:95 fused_multi_single_bev, the
// reference's BatchMultiBevGen.cpp:261-373).  pctpu builds both rasters on
// the TPU with two key sorts and a Hillis-Steele OR scan, because a TPU
// scatter is slow; Hopper has fast global atomics instead, so:
//
// bev_raster_kernel: one thread per point over the batch.  A valid,
//    non-ground point inside the 224² grid does atomicMax of its height into
//    hgt[b, cell] and, when its layer is in range, atomicOr of 1 << layer
//    into occ[b, cell] — two separate words per cell: a single word with
//    atomicOr + atomicMax would let the occupancy bits of other points
//    decide the max of the height byte.  OR and max are commutative, so the
//    result does not depend on the order of the atomics.
// bev_expand_kernel: one thread per (cloud, cell) expands the words into
//    (B, L, S, S) u8 of 0/255 and (B, S, S) u8.
//
// The index arithmetic is pctpu's, written with __f*_rn intrinsics so nvcc
// contracts nothing, and with cvt.rzi (saturating, NaN -> 0) for every
// f32 -> int32, which is XLA's astype(int32).  Bound by the atomics' and the
// output's bytes: ≈ 1.1 M points and 9.6 MB of output per batch of eight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void bev_raster_kernel(const float* __restrict__ xyz,
                                  const int32_t* __restrict__ label,
                                  const int64_t* __restrict__ count, int64_t b,
                                  int64_t p, int s, int nl, float range,
                                  float interval, float height_res,
                                  float layer_offset, float height_offset,
                                  float height_scale, unsigned* __restrict__ occ,
                                  int* __restrict__ hgt) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= b * p) return;
  const int64_t cloud = i / p;
  if (i - cloud * p >= count[cloud] || label[i] == 0) return;
  const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  const int cx = bev_cell(x, range, interval);
  const int cy = bev_cell(y, range, interval);
  if (cx < 0 || cx >= s || cy < 0 || cy >= s) return;
  const int64_t cell = cloud * (int64_t)s * s + (int64_t)cx * s + cy;
  int height = f2i(truncf(__fmul_rn(__fadd_rn(z, height_offset), height_scale)));
  height = min(max(height, 0), 255);
  if (height > 0) atomicMax(&hgt[cell], height);
  const int layer = f2i(c_round(__fadd_rn(__fdiv_rn(z, height_res), layer_offset)));
  if (layer >= 0 && layer < nl) atomicOr(&occ[cell], 1u << layer);
}

__global__ void bev_expand_kernel(const unsigned* __restrict__ occ,
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

}  // namespace

extern "C" {

// occ and hgt must be zero on entry.  Returns cudaGetLastError() after the
// two launches.
int pctpu_bev_raster(const float* xyz, const int32_t* label,
                     const int64_t* count, int64_t b, int64_t p, int s, int nl,
                     float range, float interval, float height_res,
                     float layer_offset, float height_offset,
                     float height_scale, int* occ, int* hgt, uint8_t* multi,
                     uint8_t* single, void* stream) {
  if (b <= 0 || p <= 0 || s <= 0 || nl <= 0 || nl > 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  bev_raster_kernel<<<(unsigned)((b * p + threads - 1) / threads), threads, 0, st>>>(
      xyz, label, count, b, p, s, nl, range, interval, height_res, layer_offset,
      height_offset, height_scale, reinterpret_cast<unsigned*>(occ), hgt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = b * (int64_t)s * s;
  bev_expand_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0, st>>>(
      reinterpret_cast<const unsigned*>(occ), hgt, b, s, nl, multi, single);
  return (int)cudaGetLastError();
}

}  // extern "C"
