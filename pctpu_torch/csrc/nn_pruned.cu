// Hand-written Hopper kernel of the registration slice, built by nvcc with
// the other sources of csrc/ into one shared library with a plain C
// interface (pctpu_torch/ops/_cuda.py) and launched through ctypes on
// PyTorch's current stream.
//
// nn_pruned_kernel<TQ, TT, MODE>: exact bbox-pruned 1-NN of spatially
//    (Morton) sorted queries in a spatially sorted target.
//
//    The first Hopper design of the TPU kernel scripts/exp_nn_argmin.py:118
//    (make_kernel(...).kernel): one block-wide loop with several argmin
//    bodies and tile shapes.  csrc/nn_variant.cu took its place (the same
//    instances on K1's warp design); this one stays as pctpu_nn_variant_v1,
//    so that the first design, the new one and the twin can be held and
//    timed in one call.  Its <128, 1024, kProd> instance is also the first
//    Hopper form of the production 1-NN (the TPU kernels
//    pctpu/ops/pallas_knn.py:275 and :221), csrc/nn_pruned_warp.cu's
//    yardstick.  Every MODE
//    returns the same winners; they differ in how the per-tile argmin is
//    formed:
//      kProd       running (d², index) pair, one compare per target;
//      kExplicit2  per tile the minimum d² first, then the lowest index that
//                  reaches it (two passes over the tile);
//      kKey        the index rides the value's reduction: the minimum of the
//                  64-bit key (d² bits << 32 | index) — d² ≥ 0, so its bits
//                  order as unsigned, and the lowest index wins a tie;
//      kBf16       the tile staged in shared memory as bf16 coordinates (8
//                  bytes a point instead of 16), widened to f32 for the
//                  same fma chain; queries are rounded to bf16 alike.  The
//                  wrapper builds the tile boxes from the rounded
//                  coordinates, so pruning stays exact for them.
//
//    Design.  One block per tile of TQ queries, one thread per query.  The
//    block walks the target tiles of TT points starting at the diagonal tile
//    (pallas_knn.py:212-218), and skips a tile when the squared gap between
//    the two tiles' bounding boxes exceeds min(thr², max over the block of
//    the current best d²) — exact, because every point of a skipped tile
//    lies at least that far from every query.  A visited tile is staged in
//    dynamic shared memory (TT = 4096 float4 is 64 KB, past the 48 KB of
//    static shared memory) with coalesced loads; each thread scans it and
//    keeps (best d², best index), ties going to the lowest global index.
//    Distances are the direct (q−t)², written with explicit intrinsics as
//    fma(dz, dz, fma(dy, dy, dx·dx)) — each step correctly rounded, nothing
//    left for nvcc to contract or reorder.  It is the form XLA's CPU backend
//    gives pctpu's re-derived distance, and the form of the torch twin
//    (cuda_knn.nn_1_pruned_reference via knn.sq_dist), so the kernel, the
//    twin and the wrapper's re-derivation agree bit for bit.  The TPU's
//    |t|² − 2q·t score form is not used.  The box gap is built with the same
//    fma chain: each step is monotone in its inputs, so a point's computed
//    d² is never below its tile's computed gap and the pruning stays exact
//    in floating point.
//
//    What bounds it on the card: visited tiles × TT points × about 9 flops
//    per (query, target) pair on the CUDA cores (K = 3, so tensor cores buy
//    nothing and TF32 would break winners); the visited-tile fraction is set
//    by the pruning.  Each visited tile also costs one block-wide max
//    reduction and two barriers, which larger tiles amortise over more
//    pairs at the price of coarser boxes (the tile sweep measures which
//    wins).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kBig = 3e38f;

enum Mode { kProd = 0, kExplicit2 = 1, kKey = 2, kBf16 = 3 };

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two bf16 values in one word: lo in bits 0-15, hi in bits 16-31; widening
// back to f32 is exact (a shift)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// max of v over the block; every thread gets the result
template <int TQ>
__device__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous call's readers are done with scratch
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < TQ / 32; ++w) r = fmaxf(r, scratch[w]);
  return r;
}

// a staged target point: (x, y, z, valid) as float4, or for kBf16 the four
// as bf16 in two words
template <int MODE>
using TileElem = std::conditional_t<MODE == kBf16, uint2, float4>;

template <int TQ, int TT, int MODE>
__global__ void __launch_bounds__(TQ)
nn_pruned_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask,
                 int64_t nq, const float* __restrict__ t,
                 const uint8_t* __restrict__ tmask, int64_t nt,
                 const float* __restrict__ qbox, int64_t nq_tiles,
                 const float* __restrict__ tbox, int64_t nt_tiles, float thr2,
                 float* __restrict__ out_val, int32_t* __restrict__ out_idx) {
  using Elem = TileElem<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  Elem* tile = reinterpret_cast<Elem*>(smem);
  __shared__ float scratch[TQ / 32];

  const int64_t i = blockIdx.x;
  const int64_t qi = i * TQ + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  bool qvalid = false;
  if (qi < nq) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
    qvalid = qmask[qi] != 0;
  }
  if constexpr (MODE == kBf16) {
    qx = round_bf16(qx);
    qy = round_bf16(qy);
    qz = round_bf16(qz);
  }
  // masked queries start at −BIG: they never update and never hold the
  // block's bound open
  float best = qvalid ? kBig : -kBig;
  int32_t best_j = 0;
  // kKey: the running minimum of (d² bits << 32 | index), from (BIG, 0)
  unsigned long long best_key = (unsigned long long)__float_as_uint(kBig) << 32;

  // box planes are (8, n_tiles): rows min x, y, z, max x, y, z
  const float qlx = qbox[i], qly = qbox[nq_tiles + i], qlz = qbox[2 * nq_tiles + i];
  const float qhx = qbox[3 * nq_tiles + i], qhy = qbox[4 * nq_tiles + i],
              qhz = qbox[5 * nq_tiles + i];

  float bound = fminf(thr2, block_max<TQ>(best, scratch));
  const int64_t diag = i * nt_tiles / nq_tiles;
  for (int64_t j = 0; j < nt_tiles; ++j) {
    const int64_t jj = (diag + j) % nt_tiles;
    const float gx = gap1(qlx, qhx, tbox[jj], tbox[3 * nt_tiles + jj]);
    const float gy = gap1(qly, qhy, tbox[nt_tiles + jj], tbox[4 * nt_tiles + jj]);
    const float gz = gap1(qlz, qhz, tbox[2 * nt_tiles + jj], tbox[5 * nt_tiles + jj]);
    const float gap = __fmaf_rn(gz, gz, __fmaf_rn(gy, gy, __fmul_rn(gx, gx)));
    if (!(gap <= bound)) continue;  // uniform over the block

    const int64_t base = jj * TT;
    __syncthreads();  // every thread is done with the previous tile
    for (int k = threadIdx.x; k < TT; k += TQ) {
      // this branch form of the staging load measured ≈ 1% faster on the
      // fine pass than a select per coordinate
      const int64_t g = base + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < nt) v = make_float4(t[3 * g], t[3 * g + 1], t[3 * g + 2],
                                  tmask[g] ? 1.f : 0.f);
      if constexpr (MODE == kBf16)
        tile[k] = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
      else
        tile[k] = v;
    }
    __syncthreads();
    const int n_here = (int)min((int64_t)TT, nt - base);

    if constexpr (MODE == kProd || MODE == kBf16) {
      for (int k = 0; k < n_here; ++k) {
        const Elem v = tile[k];
        float tx, ty, tz;
        bool tvalid;
        if constexpr (MODE == kBf16) {
          tx = bf16_lo(v.x);
          ty = bf16_hi(v.x);
          tz = bf16_lo(v.y);
          tvalid = bf16_hi(v.y) != 0.f;
        } else {
          tx = v.x;
          ty = v.y;
          tz = v.z;
          tvalid = v.w != 0.f;
        }
        const float d = sqdist(qx, qy, qz, tx, ty, tz);
        const int32_t jg = (int32_t)(base + k);
        if (tvalid && (d < best || (d == best && jg < best_j))) {
          best = d;
          best_j = jg;
        }
      }
    } else if constexpr (MODE == kExplicit2) {
      float m = __int_as_float(0x7f800000);  // +inf: no valid target yet
      for (int k = 0; k < n_here; ++k) {
        const float4 v = tile[k];
        const float d = sqdist(qx, qy, qz, v.x, v.y, v.z);
        if (v.w != 0.f) m = fminf(m, d);
      }
      int kmin = n_here;
      for (int k = 0; k < n_here && kmin == n_here; ++k) {
        const float4 v = tile[k];
        if (v.w != 0.f && sqdist(qx, qy, qz, v.x, v.y, v.z) == m) kmin = k;
      }
      if (kmin < n_here) {
        const int32_t jg = (int32_t)(base + kmin);
        if (m < best || (m == best && jg < best_j)) {
          best = m;
          best_j = jg;
        }
      }
    } else {  // kKey
      for (int k = 0; k < n_here; ++k) {
        const float4 v = tile[k];
        const float d = sqdist(qx, qy, qz, v.x, v.y, v.z);
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(d) << 32) | (uint32_t)(base + k);
        if (v.w != 0.f && key < best_key) best_key = key;
      }
      if (qvalid) {
        best = __uint_as_float((uint32_t)(best_key >> 32));
        best_j = (int32_t)(uint32_t)best_key;
      }
    }
    bound = fminf(thr2, block_max<TQ>(best, scratch));
  }
  if (qi < nq) {
    out_val[qi] = best;
    out_idx[qi] = best_j;
  }
}

template <int TQ, int TT, int MODE>
int launch(const float* q, const uint8_t* qmask, int64_t nq, const float* t,
           const uint8_t* tmask, int64_t nt, const float* qbox, const float* tbox,
           float thr2, float* out_val, int32_t* out_idx, cudaStream_t stream) {
  constexpr int smem = TT * (int)sizeof(TileElem<MODE>);
  // raise the dynamic shared-memory limit on every launch: the attribute
  // belongs to the current device, and the call is cheap
  const cudaError_t attr = cudaFuncSetAttribute(
      nn_pruned_kernel<TQ, TT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (nq <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nq_tiles = (nq + TQ - 1) / TQ;
  const int64_t nt_tiles = (nt + TT - 1) / TT;
  nn_pruned_kernel<TQ, TT, MODE><<<(unsigned)nq_tiles, TQ, smem, stream>>>(
      q, qmask, nq, t, tmask, nt, qbox, nq_tiles, tbox, nt_tiles, thr2,
      out_val, out_idx);
  return (int)cudaGetLastError();
}

using Launcher = int (*)(const float*, const uint8_t*, int64_t, const float*,
                         const uint8_t*, int64_t, const float*, const float*, float,
                         float*, int32_t*, cudaStream_t);

struct Instance {
  int tq, tt, mode;
  Launcher fn;
};

// the compiled variants, as X(TQ, TT, MODE) entries: the build includes a
// header defining the list pctpu_torch/ops/_cuda.py NN_INSTANCES names
#ifndef NN_INSTANCES
#error "NN_INSTANCES is not defined: build through pctpu_torch/ops/_cuda.py"
#endif
const Instance kInstances[] = {
#define X(tq, tt, mode) {tq, tt, mode, launch<tq, tt, mode>},
    NN_INSTANCES
#undef X
};

}  // namespace

extern "C" {

// The launchers return cudaGetLastError() right after the launch: a launch
// the card refuses never runs, and a later synchronize would not report it.

int pctpu_nn_variant_v1(const float* q, const uint8_t* qmask, int64_t nq,
                        const float* t, const uint8_t* tmask, int64_t nt,
                        const float* qbox, int64_t tq, const float* tbox, int64_t tt,
                        int mode, float thr2, float* out_val, int32_t* out_idx,
                        void* stream) {
  for (const Instance& in : kInstances)
    if (in.tq == tq && in.tt == tt && in.mode == mode)
      return in.fn(q, qmask, nq, t, tmask, nt, qbox, tbox, thr2, out_val, out_idx,
                   (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
