// Hand-written Hopper kernel, built by nvcc with the other sources of csrc/
// into one shared library with a plain C interface
// (pctpu_torch/ops/_cuda.py) and launched through ctypes on PyTorch's
// current stream.
//
// nn_fused_kernel: unpruned fused 1-NN.  Replaces the TPU kernel
//    pctpu/ops/pallas_knn.py:38 (_nn_kernel, called by pallas_nn_1 at :84):
//    for every query a running minimum of the score |t|² − 2·q·t over every
//    target and its index, so the (Q, T) matrix never exists.  The |q|² term
//    is constant per query and left out; the wrapper re-derives the
//    winner's exact d².
//
//    It computes what the TPU kernel computes, with each step written as a
//    correctly rounded intrinsic, so that its plain twin
//    (cuda_knn.nn_1_fused_reference) can agree bit for bit:
//      cross = fma(qz, tz, fma(qy, ty, qx·tx));
//      |t|²  = fma(tz, tz, fma(ty, ty, tx·tx)), computed while the tile is
//              staged; masked and padded targets carry 3e38, as pctpu's
//              _plane_layout gives them (pallas_knn.py:64-80);
//      score = fma(−2, cross, |t|²), equal to pctpu's t_sq − 2.0·cross
//              because 2·cross is exact.
//    Targets are scanned in ascending order with a strict <, starting from
//    (3e38, 0): the first minimum wins, as the TPU kernel's per-tile argmin
//    and strict merge give it.
//
//    Design.  One block of TQ = 256 threads per tile of queries, one thread
//    per query in registers; target tiles of TT = 2048 points staged as
//    float4 (x, y, z, |t|²) in shared memory (32 KB) with coalesced loads,
//    read back as broadcasts (every thread of a warp reads the same point).
//
//    What bounds it on the card: Q·T pairs × 4 fma-class instructions (3 for
//    the cross term and the score, a compare and select) on the CUDA cores,
//    plus one shared-memory broadcast load per pair.  K = 3 is too narrow
//    for the tensor cores, and TF32 would move winners.  No pruning: the
//    pass is Q·T work whatever the geometry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3e38f;
constexpr int kTQ = 256;
constexpr int kTT = 2048;

__global__ void __launch_bounds__(kTQ)
nn_fused_kernel(const float* __restrict__ q, int64_t nq,
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
      const float4 v = tile[k];
      const float cross = __fmaf_rn(qz, v.z, __fmaf_rn(qy, v.y, __fmul_rn(qx, v.x)));
      const float score = __fmaf_rn(-2.0f, cross, v.w);
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

// Returns cudaGetLastError() right after the launch: a launch the card
// refuses never runs, and a later synchronize would not report it.
int pctpu_nn_fused(const float* q, int64_t nq, const float* t, const uint8_t* tmask,
                   int64_t nt, float* out_val, int32_t* out_idx, void* stream) {
  if (nq <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (nq + kTQ - 1) / kTQ;
  nn_fused_kernel<<<(unsigned)blocks, kTQ, 0, (cudaStream_t)stream>>>(
      q, nq, t, tmask, nt, out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
