// Hand-written Hopper kernels of the argmin and tile-shape variants of the
// bbox-pruned 1-NN, built by nvcc with the other sources of csrc/ into one
// shared library with a plain C interface (pctpu_torch/ops/_cuda.py) and
// launched through ctypes on PyTorch's current stream.
//
// Replaces the TPU kernel scripts/exp_nn_argmin.py:118 (make_kernel(...)
// .kernel): pctpu's production loop kernel (pctpu/ops/pallas_knn.py:275)
// with five argmin bodies and a sweep of (tq, tt) tile shapes.  Here each
// variant is an instance <TQ, TT, MODE> of the warp design of
// csrc/nn_pruned_warp.cu (K1), not of a block-wide loop.
//
// Contract (cuda_knn.nn_1_pruned_variant, bit-equal to its twin
// nn_1_pruned_reference, or nn_1_pruned_bf16_reference for kBf16): K1's —
// for every query, the nearest valid target by fma(dz, dz, fma(dy, dy,
// dx·dx)) (each step correctly rounded), ties to the lowest index, and that
// d²; (0, +inf) for a masked query, a query with no target, and beyond thr².
// kBf16 picks its winner on coordinates rounded to bf16 (queries and
// targets), applies the threshold to that rounded d², and returns the
// winner's d² taken again from the f32 coordinates.
//
// The script's axes, mapped onto K1's design:
//   MODE, the argmin body of one staged 32-point group (scan_group):
//     kProd       the running (d², index) pair, a strict <, ascending;
//     kExplicit2  the lane's minimum d² over the group first, then the
//                 lowest k that reaches it (a second pass over the group in
//                 shared memory, taken only when the minimum beats the best);
//     kKey        the minimum of the 64-bit key (d² bits << 32 | index) a
//                 point — onehot_exact and onehot_mxu both;
//     kBf16       the prep packs the target rounded to bf16, four values in
//                 8 bytes, masked points at +inf, and builds the boxes from
//                 the rounded points; queries are rounded alike; groups are
//                 staged with 8-byte cp.async.ca and widened to f32 (exact)
//                 for the same fma chain.
//   TT, the target points of one main-grid work item: a tile of TT / 32
//     groups; lane l tests groups l, l + 32, …, so the passing set takes
//     TT / 1,024 ballot words.  The prep makes the 32-point group boxes and
//     the TT-point tile boxes in one launch.
//   TQ, the queries of one block: TQ / 32 warps, each with its own 32-query
//     box and live bound as in K1 (that 32 × 32 pruning is what the block
//     design lacked).  TQ sets the block size, the main grid's x extent
//     (⌈Q / TQ⌉) and the occupancy.
// So <128, 1024, kProd> is K1's own shape and design.  Tensor cores buy
// nothing: K = 3, and with one query a lane the index is in a register at
// the compare.
//
// What bounds it on the card: ≈ 9 flops a (query, target) pair on the CUDA
// cores over the pairs the pruning cannot rule out; the bytes are small
// (≈ 29 B a point in, 8 B a query out).  Four launches:
//   nn_variant_prep_kernel, once per (target, mask, TT, bf16 or not): the
//     packed points, group boxes and tile boxes, in pctpu's (8, n) layout
//     with its impossible box (min +3e38, max −3e38) for a group or tile
//     with no valid point; −0 is stored as +0.
//   nn_variant_seed_kernel, one warp per 32 sorted queries: the warp's box,
//     the group with the least worst-case distance to it, scanned by MODE's
//     body for a first candidate; each query's key and the warp's box and
//     bound min(thr², max over its valid queries).
//   nn_variant_main_kernel over (⌈Q / TQ⌉ × ⌈T / TT⌉): a warp tests the
//     tile's box against the seed's bound, then against its live bound
//     (relaxed loads of its keys), then each group box; it scans the passing
//     groups in ascending order through a double-buffered cp.async ring in
//     its own shared-memory slices, tightens the bound after each group,
//     reads its keys again at each new ballot word (TT ≥ 2,048), and merges
//     with atomicMin on the keys.  Warps synchronise only with __syncwarp.
//   nn_variant_finish_kernel: each key to (index int32, d² f32); for kBf16
//     the winner's d² from the f32 query and target.
//
// Exactness.  A group is skipped only when !(gap <= bound): the gap is the
// box-to-box fma chain, monotone in each step, so no point of a skipped
// group has a computed d² below its gap; the bound is at least every valid
// query's final best (a key only falls), so a skipped point can neither win
// nor tie.  A tile's box holds its groups' boxes, and subtraction and the
// fma chain are monotone, so the tile's gap is at most each of its groups'
// gaps: a tile skipped whole (any TT) skips only groups the group test would
// skip.  Reading the keys again between ballot words only lowers the bound
// to another value that is still at least each final best.  The ballot
// words are tested against the bound of their start, each group again
// against the live bound before its scan.  For kBf16 the boxes are built
// from the rounded points and the warp boxes from the rounded queries — the
// very values the fma chain compares — so the same argument holds for them.
// kExplicit2: fminf returns one of its operands, so the minimum is some
// point's computed d², and the first k that reproduces it is the winner of
// the ascending strict-< scan.  kKey: d² ≥ 0 (never −0), so its bits order
// as unsigned integers and the key's minimum breaks ties to the lowest
// index; +inf and NaN d² never reach a merged key (a NaN key lies above the
// initial key, a +inf one is filtered as "not found").  Across items the
// atomicMin does the same, so the result does not depend on the order in
// which the items run.  NaN coordinates make every d² NaN, which never wins
// a strict < nor a key minimum; fminf/fmaxf leave NaN out of the boxes, and
// a box gap is never NaN.  Indices are int32 (T < 2³¹), and the grid's y
// extent caps the tiles at 65,535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kBig = 3e38f;
constexpr int kGroup = 32;   // target points per group: one per lane
constexpr int kChunk = 1024; // prep: the points a block packs at a time
constexpr unsigned kFull = 0xffffffffu;
// the key of a query with no candidate yet: d² = +inf, index all ones
constexpr unsigned long long kInitKey = (0x7f800000ull << 32) | 0xffffffffull;

enum Mode { kProd = 0, kExplicit2 = 1, kKey = 2, kBf16 = 3 };

// a packed target point: float4 (x, y, z, 0), or for kBf16 the four as bf16
// in two words (x | y << 16, z | 0 << 16)
template <int MODE>
using Elem = std::conditional_t<MODE == kBf16, uint2, float4>;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float tx, float ty,
                                        float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// one axis of the box gap: max(lo_t − hi_q, lo_q − hi_t, 0)
__device__ __forceinline__ float gap1(float lo_q, float hi_q, float lo_t, float hi_t) {
  return fmaxf(fmaxf(__fsub_rn(lo_t, hi_q), __fsub_rn(lo_q, hi_t)), 0.0f);
}

// squared box-to-box gap: the warp's box (lo xyz, hi xyz) against the box
// at column c of the (8, n) planes
__device__ __forceinline__ float box_gap(const float4& lo, const float4& hi,
                                         const float* __restrict__ box, int n, int c) {
  const float gx = gap1(lo.x, hi.x, box[c], box[3 * n + c]);
  const float gy = gap1(lo.y, hi.y, box[n + c], box[4 * n + c]);
  const float gz = gap1(lo.z, hi.z, box[2 * n + c], box[5 * n + c]);
  return __fmaf_rn(gz, gz, __fmaf_rn(gy, gy, __fmul_rn(gx, gx)));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long make_key(float d, int j) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (uint32_t)j;
}

__device__ __forceinline__ float key_d(unsigned long long key) {
  return __uint_as_float((uint32_t)(key >> 32));
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
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

__device__ __forceinline__ float3 unpack(const float4& v) { return make_float3(v.x, v.y, v.z); }
__device__ __forceinline__ float3 unpack(const uint2& v) {
  return make_float3(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y));
}

__device__ __forceinline__ void cp_async(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async(uint2* smem, const uint2* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this lane's query (rounded to bf16 for kBf16) and validity (false past nq)
struct Query {
  float x, y, z;
  bool valid;
};

template <int MODE>
__device__ __forceinline__ Query load_query(const float* __restrict__ q,
                                            const uint8_t* __restrict__ qmask, int nq,
                                            int qi) {
  Query r{0.f, 0.f, 0.f, false};
  if (qi < nq) {
    r.x = q[3 * qi];
    r.y = q[3 * qi + 1];
    r.z = q[3 * qi + 2];
    r.valid = qmask[qi] != 0;
    if constexpr (MODE == kBf16) {
      r.x = round_bf16(r.x);
      r.y = round_bf16(r.y);
      r.z = round_bf16(r.z);
    }
  }
  return r;
}

// a lane's running winner: the (d², index) pair, or for kKey the 64-bit key
template <int MODE>
struct Best {
  float d;
  int j;
  __device__ __forceinline__ void init() {
    d = inf_f();
    j = 0;
  }
  __device__ __forceinline__ float value() const { return d; }
  __device__ __forceinline__ unsigned long long key() const { return make_key(d, j); }
};

template <>
struct Best<kKey> {
  unsigned long long k;
  __device__ __forceinline__ void init() { k = kInitKey; }
  __device__ __forceinline__ float value() const { return key_d(k); }
  __device__ __forceinline__ unsigned long long key() const { return k; }
};

// MODE's argmin body over one staged group s[0..31], whose first point has
// the global index base
template <int MODE>
__device__ __forceinline__ void scan_group(const Elem<MODE>* s, int base, const Query& me,
                                           Best<MODE>& b) {
  if constexpr (MODE == kProd || MODE == kBf16) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float3 t = unpack(s[k]);
      const float d = sqdist(me.x, me.y, me.z, t.x, t.y, t.z);
      if (d < b.d) {
        b.d = d;
        b.j = base + k;
      }
    }
  } else if constexpr (MODE == kExplicit2) {
    float m = inf_f();
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float3 t = unpack(s[k]);
      m = fminf(m, sqdist(me.x, me.y, me.z, t.x, t.y, t.z));
    }
    if (m < b.d) {  // the second pass: the first k whose d² is the minimum
      int k = 0;
      for (; k < kGroup - 1; ++k) {
        const float3 t = unpack(s[k]);
        if (sqdist(me.x, me.y, me.z, t.x, t.y, t.z) == m) break;
      }
      b.d = m;
      b.j = base + k;
    }
  } else {  // kKey
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float3 t = unpack(s[k]);
      const unsigned long long key = make_key(sqdist(me.x, me.y, me.z, t.x, t.y, t.z), base + k);
      if (key < b.k) b.k = key;
    }
  }
}

// the lowest group left in the ballot words, taken out of them; −1 if none
template <int W>
__device__ __forceinline__ int take_next(unsigned (&todo)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (todo[w]) {
      const int b = __ffs(todo[w]) - 1;
      todo[w] &= todo[w] - 1;
      return w * 32 + b;
    }
  }
  return -1;
}

// v[w] for a warp-uniform w, without indexing a register array at run time
template <int W>
__device__ __forceinline__ float pick(const float (&v)[W], int w) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < W; ++k)
    if (w == k) r = v[k];
  return r;
}

template <int TT, int MODE>
__global__ void __launch_bounds__(kChunk)
nn_variant_prep_kernel(const float* __restrict__ t, const uint8_t* __restrict__ tmask, int nt,
                       int n_tiles, Elem<MODE>* __restrict__ tp, float* __restrict__ gbox,
                       float* __restrict__ tbox) {
  __shared__ float part[6][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = n_tiles * (TT / kGroup);
  const float inf = inf_f();
  // this warp's share of the tile box, over its groups warp, warp + 32, …
  float acc[6] = {kBig, kBig, kBig, -kBig, -kBig, -kBig};
#pragma unroll
  for (int c = 0; c < TT / kChunk; ++c) {
    const int g = blockIdx.x * (TT / kGroup) + c * 32 + warp;
    const int p = g * kGroup + lane;
    float x = 0.f, y = 0.f, z = 0.f;
    bool valid = false;
    if (p < nt) {
      x = t[3 * p];
      y = t[3 * p + 1];
      z = t[3 * p + 2];
      valid = tmask[p] != 0;
    }
    if constexpr (MODE == kBf16) {
      x = round_bf16(x);
      y = round_bf16(y);
      z = round_bf16(z);
      tp[p] = valid ? make_uint2(pack_bf16x2(x, y), pack_bf16x2(z, 0.f))
                    : make_uint2(pack_bf16x2(inf, inf), pack_bf16x2(inf, 0.f));
    } else {
      tp[p] = valid ? make_float4(x, y, z, 0.f) : make_float4(inf, inf, inf, 0.f);
    }
    // + 0.0f turns a −0 into +0: the box bits do not depend on which zero
    // the min or max picked
    float v[6] = {warp_min(valid ? x : kBig), warp_min(valid ? y : kBig),
                  warp_min(valid ? z : kBig), warp_max(valid ? x : -kBig),
                  warp_max(valid ? y : -kBig), warp_max(valid ? z : -kBig)};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      v[k] = __fadd_rn(v[k], 0.0f);
      acc[k] = k < 3 ? fminf(acc[k], v[k]) : fmaxf(acc[k], v[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) gbox[k * ng + g] = v[k];
      gbox[6 * ng + g] = 0.f;
      gbox[7 * ng + g] = 0.f;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) part[k][warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    float w[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = k < 3 ? warp_min(part[k][lane]) : warp_max(part[k][lane]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) tbox[k * n_tiles + blockIdx.x] = w[k];
      tbox[6 * n_tiles + blockIdx.x] = 0.f;
      tbox[7 * n_tiles + blockIdx.x] = 0.f;
    }
  }
}

template <int TQ, int MODE>
__global__ void __launch_bounds__(TQ)
nn_variant_seed_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int nq,
                       const Elem<MODE>* __restrict__ tp, const float* __restrict__ gbox,
                       int ng, float thr2, unsigned long long* __restrict__ keys,
                       float4* __restrict__ wbox) {
  __shared__ __align__(16) Elem<MODE> stage[TQ / 32][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw = blockIdx.x * (TQ / 32) + warp;
  if (qw * 32 >= nq) return;  // whole warps only
  const int qi = qw * 32 + lane;
  const Query me = load_query<MODE>(q, qmask, nq, qi);
  const float inf = inf_f();
  if (!__any_sync(kFull, me.valid)) {  // nothing to find: every item skips it
    if (qi < nq) keys[qi] = kInitKey;
    if (lane == 0) {
      wbox[2 * qw] = make_float4(kBig, kBig, kBig, -inf);
      wbox[2 * qw + 1] = make_float4(-kBig, -kBig, -kBig, 0.f);
    }
    return;
  }
  const float4 lo = make_float4(warp_min(me.valid ? me.x : kBig),
                                warp_min(me.valid ? me.y : kBig),
                                warp_min(me.valid ? me.z : kBig), 0.f);
  const float4 hi = make_float4(warp_max(me.valid ? me.x : -kBig),
                                warp_max(me.valid ? me.y : -kBig),
                                warp_max(me.valid ? me.z : -kBig), 0.f);

  // the group with the least worst-case distance to the warp's box: lane l
  // takes groups l, l + 32, …; ties go to the lowest group
  float best_m = inf;
  int best_g = 0;
  for (int g = lane; g < ng; g += 32) {
    const float mx = fmaxf(fabsf(__fsub_rn(hi.x, gbox[g])),
                           fabsf(__fsub_rn(gbox[3 * ng + g], lo.x)));
    const float my = fmaxf(fabsf(__fsub_rn(hi.y, gbox[ng + g])),
                           fabsf(__fsub_rn(gbox[4 * ng + g], lo.y)));
    const float mz = fmaxf(fabsf(__fsub_rn(hi.z, gbox[2 * ng + g])),
                           fabsf(__fsub_rn(gbox[5 * ng + g], lo.z)));
    const float m = __fmaf_rn(mz, mz, __fmaf_rn(my, my, __fmul_rn(mx, mx)));
    if (m < best_m) {
      best_m = m;
      best_g = g;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(kFull, best_m, o);
    const int og = __shfl_xor_sync(kFull, best_g, o);
    if (om < best_m || (om == best_m && og < best_g)) {
      best_m = om;
      best_g = og;
    }
  }

  const int base = best_g * kGroup;
  stage[warp][lane] = tp[base + lane];
  __syncwarp();
  Best<MODE> b;
  b.init();
  scan_group<MODE>(stage[warp], base, me, b);
  const float best = b.value();
  if (qi < nq) keys[qi] = me.valid && best < inf ? b.key() : kInitKey;
  const float bound = fminf(thr2, warp_max(me.valid ? best : -inf));
  if (lane == 0) {
    wbox[2 * qw] = make_float4(lo.x, lo.y, lo.z, bound);
    wbox[2 * qw + 1] = hi;
  }
}

template <int TQ, int TT, int MODE>
__global__ void __launch_bounds__(TQ)
nn_variant_main_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int nq,
                       const Elem<MODE>* __restrict__ tp, const float* __restrict__ gbox,
                       int ng, const float* __restrict__ tbox, int n_tiles, float thr2,
                       unsigned long long* __restrict__ keys, const float4* __restrict__ wbox) {
  constexpr int kWords = TT / 1024;  // ballot words: lane l tests groups l + 32·w
  __shared__ __align__(16) Elem<MODE> stage[TQ / 32][2][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw = blockIdx.x * (TQ / 32) + warp;
  if (qw * 32 >= nq) return;
  const int tile = blockIdx.y;
  const float4 lo = wbox[2 * qw], hi = wbox[2 * qw + 1];
  const float tgap = box_gap(lo, hi, tbox, n_tiles, tile);
  if (!(tgap <= lo.w)) return;  // the seed's bound: no later bound is larger

  // the live bound: the warp's current best distances, from the keys
  const int qi = qw * 32 + lane;
  const Query me = load_query<MODE>(q, qmask, nq, qi);
  const float inf = inf_f();
  unsigned long long key = qi < nq ? load_relaxed(keys + qi) : kInitKey;
  float kd = key_d(key);
  float bound = fminf(thr2, warp_max(me.valid ? kd : -inf));
  if (!(tgap <= bound)) return;

  float ggap[kWords];
  unsigned todo[kWords];
  unsigned any = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    ggap[w] = box_gap(lo, hi, gbox, ng, tile * (TT / kGroup) + w * 32 + lane);
    todo[w] = __ballot_sync(kFull, ggap[w] <= bound);
    any |= todo[w];
  }
  if (!any) return;

  using E = Elem<MODE>;
  E(*buf)[kGroup] = stage[warp];
  const E* tile_pts = tp + (size_t)tile * TT;
  Best<MODE> b;
  b.init();
  int cur = 0;
  int gl = take_next(todo);
  cp_async(&buf[0][lane], tile_pts + gl * kGroup + lane);
  cp_async_commit();
  while (true) {
    const int gn = take_next(todo);
    if (gn >= 0) {  // prefetch the next group into the other slice
      cp_async(&buf[cur ^ 1][lane], tile_pts + gn * kGroup + lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copy of this group has landed
    // the group may have fallen behind the tightened bound meanwhile
    if (__shfl_sync(kFull, pick(ggap, gl >> 5), gl & 31) <= bound) {
      scan_group<MODE>(buf[cur], tile * TT + gl * kGroup, me, b);
      bound = fminf(bound, warp_max(me.valid ? fminf(kd, b.value()) : -inf));
    }
    if (gn < 0) break;
    if (kWords > 1 && (gn >> 5) != (gl >> 5)) {
      // a new ballot word: other items may have lowered the keys meanwhile
      key = qi < nq ? load_relaxed(keys + qi) : kInitKey;
      kd = key_d(key);
      bound = fminf(bound, warp_max(me.valid ? fminf(kd, b.value()) : -inf));
    }
    __syncwarp();  // every lane has read this slice before it is refilled
    gl = gn;
    cur ^= 1;
  }
  if (me.valid && b.value() < inf) {
    const unsigned long long mine = b.key();
    if (mine < key) atomicMin(keys + qi, mine);
  }
}

template <int MODE>
__global__ void nn_variant_finish_kernel(const float* __restrict__ q,
                                         const uint8_t* __restrict__ qmask, int nq,
                                         const float* __restrict__ t32,
                                         const unsigned long long* __restrict__ keys, float thr2,
                                         int32_t* __restrict__ out_idx,
                                         float* __restrict__ out_d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const unsigned long long key = keys[i];
  float d = key_d(key);
  // a key's d² came from sqdist on the winner itself: the twin's re-derived
  // d², bit for bit (for kBf16 on the rounded points); the init key's +inf
  // fails the test
  const bool ok = qmask[i] != 0 && d <= thr2;
  const int j = ok ? (int32_t)(uint32_t)key : 0;
  if constexpr (MODE == kBf16) {
    if (ok) d = sqdist(q[3 * i], q[3 * i + 1], q[3 * i + 2], t32[3 * j], t32[3 * j + 1],
                       t32[3 * j + 2]);
  }
  out_idx[i] = j;
  out_d2[i] = ok ? d : inf_f();
}

template <int TT, int MODE>
int launch_prep(const float* t, const uint8_t* tmask, int nt, int n_tiles, void* tp,
                float* gbox, float* tbox, cudaStream_t stream) {
  nn_variant_prep_kernel<TT, MODE><<<n_tiles, kChunk, 0, stream>>>(
      t, tmask, nt, n_tiles, static_cast<Elem<MODE>*>(tp), gbox, tbox);
  return (int)cudaGetLastError();
}

template <int TQ, int TT, int MODE>
int launch_pass(const float* q, const uint8_t* qmask, int nq, const void* tp, const float* gbox,
                const float* tbox, int n_tiles, float thr2, const float* t32, void* scratch,
                int32_t* out_idx, float* out_d2, cudaStream_t stream) {
  const int n_qw = (nq + 31) / 32;
  const int blocks = (n_qw + TQ / 32 - 1) / (TQ / 32);
  const int ng = n_tiles * (TT / kGroup);
  const Elem<MODE>* pts = static_cast<const Elem<MODE>*>(tp);
  // scratch: the warp boxes (two float4 each), then one key a query
  float4* wbox = static_cast<float4*>(scratch);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(wbox + (size_t)2 * n_qw);
  nn_variant_seed_kernel<TQ, MODE><<<blocks, TQ, 0, stream>>>(q, qmask, nq, pts, gbox, ng, thr2,
                                                              keys, wbox);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_variant_main_kernel<TQ, TT, MODE><<<dim3(blocks, n_tiles), TQ, 0, stream>>>(
      q, qmask, nq, pts, gbox, ng, tbox, n_tiles, thr2, keys, wbox);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_variant_finish_kernel<MODE><<<(nq + 255) / 256, 256, 0, stream>>>(q, qmask, nq, t32, keys,
                                                                       thr2, out_idx, out_d2);
  return (int)cudaGetLastError();
}

using PrepFn = int (*)(const float*, const uint8_t*, int, int, void*, float*, float*,
                       cudaStream_t);
using PassFn = int (*)(const float*, const uint8_t*, int, const void*, const float*,
                       const float*, int, float, const float*, void*, int32_t*, float*,
                       cudaStream_t);

struct Instance {
  int tq, tt, mode;
  PrepFn prep;  // one prep a (TT, bf16 or not): MODEs other than kBf16 share kProd's
  PassFn pass;
};

// the compiled variants, as X(TQ, TT, MODE) entries: the build includes a
// header defining the list pctpu_torch/ops/_cuda.py NN_INSTANCES names
#ifndef NN_INSTANCES
#error "NN_INSTANCES is not defined: build through pctpu_torch/ops/_cuda.py"
#endif
const Instance kInstances[] = {
#define X(tq, tt, mode) \
  {tq, tt, mode, launch_prep<tt, (mode == kBf16 ? kBf16 : kProd)>, launch_pass<tq, tt, mode>},
    NN_INSTANCES
#undef X
};

}  // namespace

extern "C" {

// Each launcher returns the first cudaGetLastError() after its launches: a
// launch the card refuses never runs, and a later synchronize would not
// report it.

// The prep of a target t (nt, 3) f32 and tmask (nt,) for the instances of
// tile tt, bf16 (1) or not (0): tp (n_tiles·tt) float4, or uint2 of four
// bf16 for bf16; gbox (8, n_tiles·tt / 32) and tbox (8, n_tiles) f32,
// n_tiles = ⌈nt / tt⌉ ≤ 65,535.
int pctpu_nn_variant_prep(const float* t, const uint8_t* tmask, int64_t nt, int64_t tt,
                          int bf16, void* tp, float* gbox, float* tbox, void* stream) {
  if (nt <= 0 || tt <= 0 || (nt + tt - 1) / tt > 65535) return (int)cudaErrorInvalidValue;
  for (const Instance& in : kInstances)
    if (in.tt == tt && (in.mode == kBf16) == (bf16 != 0))
      return in.prep(t, tmask, (int)nt, (int)((nt + tt - 1) / tt), tp, gbox, tbox,
                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// One pass of instance (tq, tt, mode) for q (nq, 3) f32 and qmask (nq,) on
// a target prepared for it (n_tiles tiles of tt points): seed, main and
// finish.  t32 is the f32 target (nt, 3) for kBf16's d² (unused otherwise);
// scratch holds 4·⌈nq / 32⌉ + nq 64-bit words; out_idx and out_d2 are (nq,).
int pctpu_nn_variant(const float* q, const uint8_t* qmask, int64_t nq, const void* tp,
                     const float* gbox, const float* tbox, int64_t n_tiles, int64_t tq,
                     int64_t tt, int mode, float thr2, const float* t32, void* scratch,
                     int32_t* out_idx, float* out_d2, void* stream) {
  if (nq <= 0 || nq > 0x7fffff00ll || n_tiles <= 0 || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  for (const Instance& in : kInstances)
    if (in.tq == tq && in.tt == tt && in.mode == mode)
      return in.pass(q, qmask, (int)nq, tp, gbox, tbox, (int)n_tiles, thr2, t32, scratch,
                     out_idx, out_d2, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
