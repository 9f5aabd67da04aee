// Hand-written Hopper kernel of the registration slice, built by nvcc with
// csrc/segment_sum.cu into one shared library with a plain C interface
// (pctpu_torch/ops/_cuda.py) and launched through ctypes on PyTorch's
// current stream.
//
// nn_pruned_kernel: exact bbox-pruned 1-NN of spatially (Morton) sorted
//    queries in a spatially sorted target.  Replaces the TPU kernels
//    pctpu/ops/pallas_knn.py:275 (_make_nn_pruned_loop_kernel) and
//    pctpu/ops/pallas_knn.py:221 (_make_nn_pruned_kernel, the 2-D-grid form
//    pctpu takes past 262,144 targets: a block here holds only one target
//    tile in shared memory, so there is no capacity cap and one kernel
//    serves both).
//
//    Design.  One block per tile of NN_TQ queries, one thread per query.
//    The block walks the target tiles of NN_TT points starting at the
//    diagonal tile (pallas_knn.py:212-218), and skips a tile when the squared
//    gap between the two tiles' bounding boxes exceeds
//    min(thr², max over the block of the current best d²) — exact, because
//    every point of a skipped tile lies at least that far from every query.
//    A visited tile is staged in shared memory with coalesced loads; each
//    thread scans it and keeps (best d², best index), ties going to the
//    lowest global index.  Distances are the direct (q−t)², written with
//    explicit intrinsics as fma(dz, dz, fma(dy, dy, dx·dx)) — each step
//    correctly rounded, nothing left for nvcc to contract or reorder.  It
//    is the form XLA's CPU backend gives pctpu's re-derived distance, and
//    the form of the torch twin (cuda_knn.nn_1_pruned_reference via
//    knn.sq_dist), so the kernel, the twin and the wrapper's re-derivation
//    agree bit for bit.  The TPU's |t|² − 2q·t score form is not used.
//    The box gap is built with the same fma chain: each step is monotone in
//    its inputs, so a point's computed d² is never below its tile's
//    computed gap and the pruning stays exact in floating point.
//
//    What bounds it on the card: visited tiles × NN_TT points × about 9
//    flops per (query, target) pair on the CUDA cores (K = 3, so tensor
//    cores buy nothing and TF32 would break winners); the visited-tile
//    fraction is set by the pruning.  Each visited tile also costs one
//    block-wide max reduction and two barriers.  Tile shapes are not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

#define NN_TQ 128
#define NN_TT 1024

namespace {

constexpr float kBig = 3e38f;

__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float tx, float ty, float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// one axis of the box gap: max(lo_t − hi_q, lo_q − hi_t, 0)
__device__ __forceinline__ float gap1(float lo_q, float hi_q, float lo_t,
                                      float hi_t) {
  return fmaxf(fmaxf(__fsub_rn(lo_t, hi_q), __fsub_rn(lo_q, hi_t)), 0.0f);
}

// max of v over the block; every thread gets the result
__device__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous call's readers are done with scratch
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < NN_TQ / 32; ++w) r = fmaxf(r, scratch[w]);
  return r;
}

__global__ void __launch_bounds__(NN_TQ)
nn_pruned_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask,
                 int64_t nq, const float* __restrict__ t,
                 const uint8_t* __restrict__ tmask, int64_t nt,
                 const float* __restrict__ qbox, int64_t nq_tiles,
                 const float* __restrict__ tbox, int64_t nt_tiles, float thr2,
                 float* __restrict__ out_val, int32_t* __restrict__ out_idx) {
  __shared__ float4 tile[NN_TT];
  __shared__ float scratch[NN_TQ / 32];

  const int64_t i = blockIdx.x;
  const int64_t qi = i * NN_TQ + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  bool qvalid = false;
  if (qi < nq) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
    qvalid = qmask[qi] != 0;
  }
  // masked queries start at −BIG: they never update and never hold the
  // block's bound open
  float best = qvalid ? kBig : -kBig;
  int32_t best_j = 0;

  // box planes are (8, n_tiles): rows min x, y, z, max x, y, z
  const float qlx = qbox[i], qly = qbox[nq_tiles + i], qlz = qbox[2 * nq_tiles + i];
  const float qhx = qbox[3 * nq_tiles + i], qhy = qbox[4 * nq_tiles + i],
              qhz = qbox[5 * nq_tiles + i];

  float bound = fminf(thr2, block_max(best, scratch));
  const int64_t diag = i * nt_tiles / nq_tiles;
  for (int64_t j = 0; j < nt_tiles; ++j) {
    const int64_t jj = (diag + j) % nt_tiles;
    const float gx = gap1(qlx, qhx, tbox[jj], tbox[3 * nt_tiles + jj]);
    const float gy = gap1(qly, qhy, tbox[nt_tiles + jj], tbox[4 * nt_tiles + jj]);
    const float gz = gap1(qlz, qhz, tbox[2 * nt_tiles + jj], tbox[5 * nt_tiles + jj]);
    const float gap = __fmaf_rn(gz, gz, __fmaf_rn(gy, gy, __fmul_rn(gx, gx)));
    if (!(gap <= bound)) continue;  // uniform over the block

    const int64_t base = jj * NN_TT;
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < NN_TT; k += NN_TQ) {
      const int64_t g = base + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < nt) v = make_float4(t[3 * g], t[3 * g + 1], t[3 * g + 2],
                                  tmask[g] ? 1.f : 0.f);
      tile[k] = v;
    }
    __syncthreads();
    const int n_here = (int)min((int64_t)NN_TT, nt - base);
    for (int k = 0; k < n_here; ++k) {
      const float4 v = tile[k];
      const float d = sqdist(qx, qy, qz, v.x, v.y, v.z);
      const int32_t jg = (int32_t)(base + k);
      if (v.w != 0.f && (d < best || (d == best && jg < best_j))) {
        best = d;
        best_j = jg;
      }
    }
    bound = fminf(thr2, block_max(best, scratch));
  }
  if (qi < nq) {
    out_val[qi] = best;
    out_idx[qi] = best_j;
  }
}

}  // namespace

extern "C" {

// The launcher returns cudaGetLastError() right after the launch: a launch
// the card refuses never runs, and a later synchronize would not report it.

int pctpu_nn_pruned(const float* q, const uint8_t* qmask, int64_t nq,
                    const float* t, const uint8_t* tmask, int64_t nt,
                    const float* qbox, int64_t tq, const float* tbox, int64_t tt,
                    float thr2, float* out_val, int32_t* out_idx, void* stream) {
  if (tq != NN_TQ || tt != NN_TT) return (int)cudaErrorInvalidValue;
  if (nq <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nq_tiles = (nq + NN_TQ - 1) / NN_TQ;
  const int64_t nt_tiles = (nt + NN_TT - 1) / NN_TT;
  nn_pruned_kernel<<<(unsigned)nq_tiles, NN_TQ, 0, (cudaStream_t)stream>>>(
      q, qmask, nq, t, tmask, nt, qbox, nq_tiles, tbox, nt_tiles, thr2,
      out_val, out_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
