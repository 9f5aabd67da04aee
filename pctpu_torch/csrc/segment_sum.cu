// Hand-written Hopper kernel of the registration slice, built by nvcc with
// csrc/nn_pruned.cu into one shared library (pctpu_torch/ops/_cuda.py).
//
// segment_sum4_kernel: per-voxel (x, y, z, count) sums of the voxel grid
//    (pctpu/ops/voxel.py:80).  pctpu's scatter-add sums each voxel's points
//    in input order; CUDA's index_add_ uses atomics, whose order changes from
//    run to run.  Here one thread per segment adds its rows sequentially in
//    sorted (= stable input) order from 0.0, so the sums are deterministic
//    and bit-equal to the in-order scatter.  Bound by the longest segment;
//    voxels hold few points.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_sum4_kernel(const float4* __restrict__ v,
                                    const int64_t* __restrict__ seg, int64_t n,
                                    float4* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = seg[i];
  if (s < 0 || (i > 0 && seg[i - 1] == s)) return;  // not a segment head
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t j = i;
  do {
    const float4 x = v[j];
    acc.x = __fadd_rn(acc.x, x.x);
    acc.y = __fadd_rn(acc.y, x.y);
    acc.z = __fadd_rn(acc.z, x.z);
    acc.w = __fadd_rn(acc.w, x.w);
    ++j;
  } while (j < n && seg[j] == s);
  out[s] = acc;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch.
int pctpu_segment_sum4(const float* values, const int64_t* seg, int64_t n,
                       float* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  segment_sum4_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(values), seg, n,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
