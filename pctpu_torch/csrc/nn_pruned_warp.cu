// Hand-written Hopper kernels of the bbox-pruned 1-NN, built by nvcc with the
// other sources of csrc/ into one shared library with a plain C interface
// (pctpu_torch/ops/_cuda.py) and launched through ctypes on PyTorch's
// current stream.
//
// Replaces the TPU kernels pctpu/ops/pallas_knn.py:275
// (_make_nn_pruned_loop_kernel, every ICP correspondence and fitness pass,
// and under jax.vmap at pallas_knn.py:430-435 the pair-batched stages' pass)
// and pctpu/ops/pallas_knn.py:221 (_make_nn_pruned_kernel, the 2-D-grid form
// pctpu takes past 262,144 targets: nothing here depends on the target's
// size but the list's, so one design serves both).
//
// Contract (cuda_knn.nn_1_pruned, bit-equal to its twin
// nn_1_pruned_reference): for every query, the nearest valid target by
// fma(dz, dz, fma(dy, dy, dx·dx)) (each step correctly rounded, the form
// XLA's CPU backend gives pctpu), ties to the lowest index, and that d²;
// (0, +inf) for a masked query, a query with no target, and beyond thr².
//
// What bounds it on the card: the bytes are small (≈ 29 B a point in, 8 B a
// query out), and the operations are ≈ 9 flops a (query, target) pair over
// the pairs the pruning cannot rule out — so the design is about visiting
// few pairs, about spending no time on work that the pruning rules out, and
// about no single walk setting the time.  A pass over P problems (pctpu's K1
// under jax.vmap; one problem is P = 1) is a memset and three launches:
//
//   nn_prep_kernel, once per (target, mask), Bt targets of one padded
//     length in one launch (grid (tiles, Bt)): the sorted target packed as
//     float4 with masked and padding points at +inf (they lose every strict
//     compare, so the scan tests no validity), the box of each 32-point
//     group and of each 1,024-point tile, in pctpu's (8, n) layout with its
//     impossible box (min +3e38, max −3e38) for a group with no valid point.
//     Box values are canonical: −0 is stored as +0.
//   the list's count set to 0 (cudaMemsetAsync).
//   nn_seed_kernel, one warp per 32 consecutive sorted queries of a problem
//     (the problem on blockIdx.y): the warp's box (shuffles); a seed group
//     picked in two levels — lanes over the target's tile boxes, then lane l
//     over group l of the best tile, so a warp reads tiles + 32 boxes where a
//     pick over every group read all of them — and scanned for a first
//     candidate per query; each query's 64-bit key (d² bits << 32 | index),
//     the warp's box, and its bound min(thr², max over its valid queries).
//     Then the same warp tests every tile box against that bound and
//     appends each tile that passes as a work item (problem, tile, query
//     warp), one atomicAdd a block on the count.
//   nn_main_kernel, a persistent grid (the blocks that fit on the card at
//     once, no more than the list could need) that strides over the list by
//     the count on the card (the host never reads it).  Each item: the tile
//     test against the live bound min(thr², the warp's current max best d²,
//     from the keys with relaxed atomic loads), each lane one of the tile's
//     32 group boxes, the groups that pass scanned in ascending order with a
//     strict <, the bound tightened after each; the groups are staged into
//     the warp's ring of four shared-memory slices with cp.async, three
//     copies ahead of the scan; the warp's candidates merge with atomicMin
//     on the keys.  Each item is at most 32 groups of 32 points, so the
//     critical path is one item, not the busiest warp's walk over the target.
//   nn_finish_kernel: each key to the contract's (index int32, d² f32).
//
// The list holds exactly the (problem, query warp, tile) blocks of the first
// warp design's dense grid (kept below as nn_seed_v1_kernel /
// nn_main_v1_kernel, entry pctpu_nn_pruned_batched_v1) that pass its first
// test, the tile's gap against the seed's bound: the dense grid launched all
// of them (384 × 48 × 16 blocks of four warps for 16 problems of 49,152
// points) and most returned after that one test.
//
// Problem p reads target p / (P / Bt), so the two yaw guesses of a coarse
// pair share their pair's prepared target.  Keys, warp boxes and outputs are
// per problem, so the exactness argument below holds problem by problem and a
// batched pass is bit-equal to P single passes.
//
// Exactness.  A group is skipped only when !(gap <= bound): the gap is the
// box-to-box fma chain, monotone in each step, so no point of a skipped
// group has a computed d² ≤ its gap; the bound is at least every valid
// query's final best (a key only falls), so a skipped point can neither win
// nor tie.  The same holds for a tile left out of the list (its gap against
// the seed's bound, the largest bound the warp ever has).  d² ≥ 0, so the
// key's bits order as unsigned integers and the min breaks ties to the
// lowest index: the result depends neither on the order in which the items
// run nor on which group seeded the bound.  Indices are int32 throughout
// (T < 2³¹; an item keeps the tile in 16 bits, so the tiles are capped at
// 65,535, as the problems are).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3e38f;
constexpr int kGroup = 32;            // target points per group: one per lane
constexpr int kTile = 1024;           // target points per tile: 32 groups
constexpr int kWarps = 4;             // warps per block of the first design's launches
constexpr int kSeedWarps = 8;         // warps per seed block: one list append a block
constexpr int kMainWarps = 4;         // warps per block of the persistent main grid
constexpr int kStages = 4;            // slices in a main warp's ring of staged groups
static_assert((kStages & (kStages - 1)) == 0, "the ring's slot is a mask");
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPairsPerGroup = 32ull * kGroup;
// the key of a query with no candidate yet: d² = +inf, index all ones
constexpr unsigned long long kInitKey = (0x7f800000ull << 32) | 0xffffffffull;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float tx,
                                        float ty, float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// one axis of the box gap: max(lo_t − hi_q, lo_q − hi_t, 0)
__device__ __forceinline__ float gap1(float lo_q, float hi_q, float lo_t, float hi_t) {
  return fmaxf(fmaxf(__fsub_rn(lo_t, hi_q), __fsub_rn(lo_q, hi_t)), 0.0f);
}

// squared box-to-box gap: q = (lo xyz, hi xyz) of the warp; the target box is
// read from the (8, n) planes at column c
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

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this lane's query: coordinates and validity (false past nq)
struct Query {
  float x = 0.f, y = 0.f, z = 0.f;
  bool valid = false;
};

__device__ __forceinline__ Query load_query(const float* __restrict__ q,
                                            const uint8_t* __restrict__ qmask, int nq,
                                            int qi) {
  Query r;
  if (qi < nq) {
    r.x = q[3 * qi];
    r.y = q[3 * qi + 1];
    r.z = q[3 * qi + 2];
    r.valid = qmask[qi] != 0;
  }
  return r;
}

// ascending scan of one staged group with a strict <: the lowest index wins
// a tie inside the group, and groups are visited in ascending order
__device__ __forceinline__ void scan_group(const float4* s, int base, const Query& me,
                                           float& best, int& best_j) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const float4 t = s[k];
    const float d = sqdist(me.x, me.y, me.z, t.x, t.y, t.z);
    if (d < best) {
      best = d;
      best_j = base + k;
    }
  }
}

__global__ void __launch_bounds__(kTile)
nn_prep_kernel(const float* __restrict__ t, const uint8_t* __restrict__ tmask, int nt,
               int n_tiles, float4* __restrict__ tp, float* __restrict__ gbox,
               float* __restrict__ tbox) {
  __shared__ float part[6][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = n_tiles * 32;
  // this block's target of the batch
  const size_t b = blockIdx.y;
  t += b * nt * 3;
  tmask += b * nt;
  tp += b * n_tiles * kTile;
  gbox += b * 8 * ng;
  tbox += b * 8 * n_tiles;
  const int g = blockIdx.x * 32 + warp;
  const int p = g * kGroup + lane;
  float x = 0.f, y = 0.f, z = 0.f;
  bool valid = false;
  if (p < nt) {
    x = t[3 * p];
    y = t[3 * p + 1];
    z = t[3 * p + 2];
    valid = tmask[p] != 0;
  }
  const float inf = inf_f();
  tp[p] = valid ? make_float4(x, y, z, 0.f) : make_float4(inf, inf, inf, 0.f);
  // + 0.0f turns a −0 into +0: the box bits do not depend on which zero the
  // min or max picked
  float v[6] = {warp_min(valid ? x : kBig), warp_min(valid ? y : kBig),
                warp_min(valid ? z : kBig), warp_max(valid ? x : -kBig),
                warp_max(valid ? y : -kBig), warp_max(valid ? z : -kBig)};
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      v[k] = __fadd_rn(v[k], 0.0f);
      gbox[k * ng + g] = v[k];
      part[k][warp] = v[k];
    }
    gbox[6 * ng + g] = 0.f;
    gbox[7 * ng + g] = 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    float w[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      w[k] = k < 3 ? warp_min(part[k][lane]) : warp_max(part[k][lane]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) tbox[k * n_tiles + blockIdx.x] = w[k];
      tbox[6 * n_tiles + blockIdx.x] = 0.f;
      tbox[7 * n_tiles + blockIdx.x] = 0.f;
    }
  }
}

// the worst-case squared distance between the warp's box (lo, hi) and the
// box at column c of the (8, n) planes: max over the two boxes' corners
__device__ __forceinline__ float box_worst(const float4& lo, const float4& hi,
                                           const float* __restrict__ box, int n, int c) {
  const float mx = fmaxf(fabsf(__fsub_rn(hi.x, box[c])), fabsf(__fsub_rn(box[3 * n + c], lo.x)));
  const float my =
      fmaxf(fabsf(__fsub_rn(hi.y, box[n + c])), fabsf(__fsub_rn(box[4 * n + c], lo.y)));
  const float mz =
      fmaxf(fabsf(__fsub_rn(hi.z, box[2 * n + c])), fabsf(__fsub_rn(box[5 * n + c], lo.z)));
  return __fmaf_rn(mz, mz, __fmaf_rn(my, my, __fmul_rn(mx, mx)));
}

// the warp's least (m, i), ties to the lowest i; every lane gets it (no m
// is NaN: callers start from +inf and keep only m < their best)
__device__ __forceinline__ void warp_argmin(float& m, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(kFull, m, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (om < m || (om == m && oi < i)) {
      m = om;
      i = oi;
    }
  }
}

// a work item: (problem, target tile, query warp) in one word
__device__ __forceinline__ unsigned long long make_item(int p, int tile, int qw) {
  return ((unsigned long long)p << 48) | ((unsigned long long)tile << 32) | (uint32_t)qw;
}

// Seed, one warp per 32 consecutive sorted queries of a problem: the warp's
// box; the seed group by a two-level pick (lanes over the target's tile
// boxes, the tile with the least worst-case distance, ties to the lowest;
// then lane l over group l of that tile), scanned for a first candidate per
// query; each query's key, the warp's box and its bound min(thr², max over
// its valid queries).  Then the work list: every tile whose box gap passes
// that bound is one item (problem, tile, query warp), appended with one
// atomicAdd a block on the list's count.  Which group seeds does not change
// the result (the keys' merge is order-free), only the bound and so the list.
template <bool kCount>
__global__ void __launch_bounds__(kSeedWarps * 32)
nn_seed_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int nq,
               const float4* __restrict__ tp, const float* __restrict__ gbox,
               const float* __restrict__ tbox, int n_tiles, int per_target, float thr2,
               unsigned long long* __restrict__ keys, float4* __restrict__ wbox,
               unsigned long long* __restrict__ list, unsigned long long* __restrict__ n_items,
               unsigned long long* __restrict__ counter) {
  __shared__ __align__(16) float4 stage[kSeedWarps][kGroup];
  __shared__ unsigned found[kSeedWarps];
  __shared__ unsigned long long block_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_qw = (nq + 31) / 32;
  const int qw = blockIdx.x * kSeedWarps + warp;
  const bool live = qw < n_qw;  // whole warps only; a block may end past the last
  // this block's problem and the target it searches
  const int p = blockIdx.y;
  const size_t tb = blockIdx.y / per_target;
  q += (size_t)p * nq * 3;
  qmask += (size_t)p * nq;
  keys += (size_t)p * nq;
  wbox += (size_t)p * 2 * n_qw;
  const int ng = n_tiles * 32;
  tp += tb * ng * kGroup;
  gbox += tb * 8 * ng;
  tbox += tb * 8 * n_tiles;
  const float inf = inf_f();
  float4 lo = make_float4(kBig, kBig, kBig, 0.f), hi = make_float4(-kBig, -kBig, -kBig, 0.f);
  float bound = -inf;  // a warp with no valid query: no tile passes
  if (live) {
    const int qi = qw * 32 + lane;
    const Query me = load_query(q, qmask, nq, qi);
    if (!__any_sync(kFull, me.valid)) {  // nothing to find: no item, no candidate
      if (qi < nq) keys[qi] = kInitKey;
    } else {
      lo = make_float4(warp_min(me.valid ? me.x : kBig), warp_min(me.valid ? me.y : kBig),
                       warp_min(me.valid ? me.z : kBig), 0.f);
      hi = make_float4(warp_max(me.valid ? me.x : -kBig), warp_max(me.valid ? me.y : -kBig),
                       warp_max(me.valid ? me.z : -kBig), 0.f);
      float m = inf;
      int best_t = 0;
      for (int t = lane; t < n_tiles; t += 32) {
        const float w = box_worst(lo, hi, tbox, n_tiles, t);
        if (w < m) {
          m = w;
          best_t = t;
        }
      }
      warp_argmin(m, best_t);
      int best_g = best_t * 32 + lane;
      const float w = box_worst(lo, hi, gbox, ng, best_g);
      m = w < inf ? w : inf;
      warp_argmin(m, best_g);

      const int base = best_g * kGroup;
      stage[warp][lane] = tp[base + lane];
      __syncwarp();
      float best = inf;
      int best_j = 0;
      scan_group(stage[warp], base, me, best, best_j);
      if (kCount && lane == 0) atomicAdd(counter, kPairsPerGroup);
      if (qi < nq) keys[qi] = me.valid && best < inf ? make_key(best, best_j) : kInitKey;
      bound = fminf(thr2, warp_max(me.valid ? best : -inf));
    }
    if (lane == 0) {
      wbox[2 * qw] = lo;
      wbox[2 * qw + 1] = hi;
    }
  }

  // the warp's items: count them, take the block's span of the list, write
  unsigned mine = 0;
  if (live && bound > -inf)
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool pass = t < n_tiles && box_gap(lo, hi, tbox, n_tiles, t) <= bound;
      mine += __popc(__ballot_sync(kFull, pass));
    }
  if (lane == 0) found[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kSeedWarps; ++w) total += found[w];
    block_base = total ? atomicAdd(n_items, (unsigned long long)total) : 0;
  }
  __syncthreads();
  if (!mine) return;
  unsigned long long at = block_base;
  for (int w = 0; w < warp; ++w) at += found[w];
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int t = t0 + lane;
    const bool pass = t < n_tiles && box_gap(lo, hi, tbox, n_tiles, t) <= bound;
    const unsigned b = __ballot_sync(kFull, pass);
    if (pass) list[at + __popc(b & below)] = make_item(p, t, qw);
    at += __popc(b);
  }
}

// One work item of the main grid, for one warp: the dense design's block.
// The live bound from the keys (relaxed loads), the tile test against it,
// each lane's group gap, a ballot of the groups that pass; the groups are
// staged through a ring of kStages shared-memory slices with cp.async, so
// that the copy of later groups runs under the scan of this one, and scanned
// in ascending order with a strict <, the bound tightened after each (a
// group not yet copied that falls behind it is never copied); the warp's
// candidates merge with atomicMin on the keys.
template <bool kCount>
__device__ __forceinline__ void run_item(unsigned long long item, const float4& lo,
                                         const float4& hi, const float* __restrict__ q,
                                         const uint8_t* __restrict__ qmask, int nq,
                                         const float4* __restrict__ tp,
                                         const float* __restrict__ gbox,
                                         const float* __restrict__ tbox, int n_tiles,
                                         int per_target, float thr2,
                                         unsigned long long* __restrict__ keys,
                                         float4 (*buf)[kGroup], int lane,
                                         unsigned long long* __restrict__ counter) {
  const int p = (int)(item >> 48), tile = (int)((item >> 32) & 0xffff), qw = (int)(uint32_t)item;
  const int ng = n_tiles * 32;
  const size_t tb = p / per_target;
  const float tgap = box_gap(lo, hi, tbox + tb * 8 * n_tiles, n_tiles, tile);

  // the live bound: the warp's current best distances, from the keys
  const float inf = inf_f();
  const int qi = qw * 32 + lane;
  const Query me = load_query(q + (size_t)p * nq * 3, qmask + (size_t)p * nq, nq, qi);
  unsigned long long* pkeys = keys + (size_t)p * nq;
  const unsigned long long key = qi < nq ? load_relaxed(pkeys + qi) : kInitKey;
  const float kd = __uint_as_float((uint32_t)(key >> 32));
  float bound = fminf(thr2, warp_max(me.valid ? kd : -inf));
  if (!(tgap <= bound)) return;

  // lane l tests group l of the tile
  const float ggap = box_gap(lo, hi, gbox + tb * 8 * ng, ng, tile * 32 + lane);
  unsigned todo = __ballot_sync(kFull, ggap <= bound);  // groups to copy
  if (!todo) return;

  const float4* tile_pts = tp + (tb * n_tiles + tile) * kTile;
  unsigned left = 0;  // groups copied, not yet scanned: ascending = in copy order
  int issued = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (todo) {
      const int g = __ffs(todo) - 1;
      todo &= todo - 1;
      left |= 1u << g;
      cp_async16(&buf[issued++][lane], tile_pts + g * kGroup + lane);
    }
    cp_async_commit();
  }
  float best = inf;
  int best_j = 0;
  // the copies form a prefix of the commit groups (once todo is empty it
  // stays empty), so after commit i + kStages - 1 and a wait for all but the
  // last kStages - 1 groups, the i-th group copied has landed
  for (int i = 0; left; ++i) {
    todo &= __ballot_sync(kFull, ggap <= bound);  // drop what the bound rules out
    if (todo) {
      const int g = __ffs(todo) - 1;
      todo &= todo - 1;
      left |= 1u << g;
      cp_async16(&buf[issued++ & (kStages - 1)][lane], tile_pts + g * kGroup + lane);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copy of this group has landed
    const int gl = __ffs(left) - 1;
    left &= left - 1;
    // the group may have fallen behind the tightened bound meanwhile
    if (__shfl_sync(kFull, ggap, gl) <= bound) {
      scan_group(buf[i & (kStages - 1)], tile * kTile + gl * kGroup, me, best, best_j);
      if (kCount && lane == 0) atomicAdd(counter, kPairsPerGroup);
      bound = fminf(bound, warp_max(me.valid ? fminf(kd, best) : -inf));
    }
    __syncwarp();  // every lane has read this slice before it is refilled
  }
  if (me.valid && best < inf) {
    const unsigned long long mine = make_key(best, best_j);
    if (mine < key) atomicMin(pkeys + qi, mine);
  }
}

// Main: a persistent grid over the work list.  Global warp w takes items w,
// w + W, w + 2W, … (W the grid's warps) up to the count the seed left on the
// card.
template <bool kCount>
__global__ void __launch_bounds__(kMainWarps * 32)
nn_main_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int nq,
               const float4* __restrict__ tp, const float* __restrict__ gbox,
               const float* __restrict__ tbox, int n_tiles, int per_target, float thr2,
               unsigned long long* __restrict__ keys, const float4* __restrict__ wbox,
               const unsigned long long* __restrict__ list,
               const unsigned long long* __restrict__ n_items,
               unsigned long long* __restrict__ counter) {
  __shared__ __align__(16) float4 stage[kMainWarps][kStages][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long n = *n_items;
  if (kCount && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counter + 1, n);
  const int n_qw = (nq + 31) / 32;
  const unsigned long long stride = (unsigned long long)gridDim.x * kMainWarps;
  for (unsigned long long it = (unsigned long long)blockIdx.x * kMainWarps + warp; it < n;
       it += stride) {
    const unsigned long long item = list[it];
    // the item's warp box, from its (problem, query warp)
    const float4* box = wbox + (size_t)(item >> 48) * 2 * n_qw + 2 * (uint32_t)item;
    run_item<kCount>(item, box[0], box[1], q, qmask, nq, tp, gbox, tbox, n_tiles, per_target,
                     thr2, keys, stage[warp], lane, counter);
    __syncwarp();  // every lane is done with the ring's slices before the next item
  }
}

// The first warp design (its problem axis included), kept for
// pctpu_nn_pruned_batched_v1: the seed scans every group box for its seed
// group; the main grid is dense, one block per (4 query warps, tile,
// problem), and a warp first tests the tile's box against the seed's bound.
__global__ void __launch_bounds__(kWarps * 32)
nn_seed_v1_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int nq,
                  const float4* __restrict__ tp, const float* __restrict__ gbox, int ng,
                  int per_target, float thr2, unsigned long long* __restrict__ keys,
                  float4* __restrict__ wbox) {
  __shared__ __align__(16) float4 stage[kWarps][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw = blockIdx.x * kWarps + warp;
  if (qw * 32 >= nq) return;  // whole warps only
  // this block's problem and the target it searches
  const size_t p = blockIdx.y, tb = blockIdx.y / per_target;
  q += p * nq * 3;
  qmask += p * nq;
  keys += p * nq;
  wbox += p * 2 * ((nq + 31) / 32);
  tp += tb * ng * kGroup;
  gbox += tb * 8 * ng;
  const int qi = qw * 32 + lane;
  const Query me = load_query(q, qmask, nq, qi);
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
    const float mx = fmaxf(fabsf(__fsub_rn(hi.x, gbox[g])), fabsf(__fsub_rn(gbox[3 * ng + g], lo.x)));
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
  float best = inf;
  int best_j = 0;
  scan_group(stage[warp], base, me, best, best_j);
  if (qi < nq) keys[qi] = me.valid && best < inf ? make_key(best, best_j) : kInitKey;
  const float bound = fminf(thr2, warp_max(me.valid ? best : -inf));
  if (lane == 0) {
    wbox[2 * qw] = make_float4(lo.x, lo.y, lo.z, bound);
    wbox[2 * qw + 1] = hi;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
nn_main_v1_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qmask, int nq,
                  const float4* __restrict__ tp, const float* __restrict__ gbox, int ng,
                  const float* __restrict__ tbox, int n_tiles, int per_target, float thr2,
                  unsigned long long* __restrict__ keys, const float4* __restrict__ wbox) {
  __shared__ __align__(16) float4 stage[kWarps][2][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qw = blockIdx.x * kWarps + warp;
  if (qw * 32 >= nq) return;
  const size_t p = blockIdx.z, tb = blockIdx.z / per_target;
  q += p * nq * 3;
  qmask += p * nq;
  keys += p * nq;
  wbox += p * 2 * ((nq + 31) / 32);
  tp += tb * n_tiles * kTile;
  gbox += tb * 8 * ng;
  tbox += tb * 8 * n_tiles;
  const int tile = blockIdx.y;
  const float4 lo = wbox[2 * qw], hi = wbox[2 * qw + 1];
  const float tgap = box_gap(lo, hi, tbox, n_tiles, tile);
  if (!(tgap <= lo.w)) return;  // the seed's bound: no later bound is larger

  // the live bound: the warp's current best distances, from the keys
  const int qi = qw * 32 + lane;
  const Query me = load_query(q, qmask, nq, qi);
  const float inf = inf_f();
  const unsigned long long key = qi < nq ? load_relaxed(keys + qi) : kInitKey;
  const float kd = __uint_as_float((uint32_t)(key >> 32));
  float bound = fminf(thr2, warp_max(me.valid ? kd : -inf));
  if (!(tgap <= bound)) return;

  // lane l tests group l of the tile
  const float ggap = box_gap(lo, hi, gbox, ng, tile * 32 + lane);
  unsigned todo = __ballot_sync(kFull, ggap <= bound);
  if (!todo) return;

  float4(*buf)[kGroup] = stage[warp];
  const float4* tile_pts = tp + tile * kTile;
  float best = inf;
  int best_j = 0;
  int cur = 0;
  int gl = __ffs(todo) - 1;
  todo &= todo - 1;
  cp_async16(&buf[0][lane], tile_pts + gl * kGroup + lane);
  cp_async_commit();
  while (true) {
    int gn = -1;
    if (todo) {  // prefetch the next group into the other slice
      gn = __ffs(todo) - 1;
      todo &= todo - 1;
      cp_async16(&buf[cur ^ 1][lane], tile_pts + gn * kGroup + lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copy of this group has landed
    // the group may have fallen behind the tightened bound meanwhile
    if (__shfl_sync(kFull, ggap, gl) <= bound) {
      scan_group(buf[cur], tile * kTile + gl * kGroup, me, best, best_j);
          bound = fminf(bound, warp_max(me.valid ? fminf(kd, best) : -inf));
    }
    if (gn < 0) break;
    __syncwarp();  // every lane has read this slice before it is refilled
    gl = gn;
    cur ^= 1;
  }
  if (me.valid && best < inf) {
    const unsigned long long mine = make_key(best, best_j);
    if (mine < key) atomicMin(keys + qi, mine);
  }
}

__global__ void nn_finish_kernel(const uint8_t* __restrict__ qmask, int nq,
                                 const unsigned long long* __restrict__ keys, float thr2,
                                 int32_t* __restrict__ out_idx, float* __restrict__ out_d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const size_t p = blockIdx.y;
  qmask += p * nq;
  keys += p * nq;
  out_idx += p * nq;
  out_d2 += p * nq;
  const unsigned long long key = keys[i];
  const float d = __uint_as_float((uint32_t)(key >> 32));
  // a key's d² came from sqdist on the winner itself: it is the twin's
  // re-derived d², bit for bit; the init key's +inf fails the test
  const bool ok = qmask[i] != 0 && d <= thr2;
  out_idx[i] = ok ? (int32_t)(uint32_t)key : 0;
  out_d2[i] = ok ? d : inf_f();
}

// The dense grid's validity limits, shared by both designs' entries.
bool pass_shape_ok(int64_t n_problems, int64_t nq, int64_t n_targets, int64_t n_tiles) {
  return nq > 0 && nq <= 0x7fffff00ll && n_tiles > 0 && n_tiles <= 65535 && n_targets > 0 &&
         n_problems > 0 && n_problems <= 65535 && n_problems % n_targets == 0;
}

// The persistent main grid: the blocks of nn_main_kernel that fit on the
// current card at once, and no more than ⌈items / warps a block⌉ for a list
// of at most `capacity` items.  The occupancy is looked up once per card.
template <bool kCount>
cudaError_t main_grid(unsigned long long capacity, int* blocks) {
  static int resident[64];  // per card: blocks a card holds at once, 0 = not looked up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int fit = dev < 64 ? resident[dev] : 0;
  if (!fit) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_main_kernel<kCount>,
                                                        kMainWarps * 32, 0);
    if (err != cudaSuccess) return err;
    fit = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) resident[dev] = fit;
  }
  const unsigned long long need = (capacity + kMainWarps - 1) / kMainWarps;
  *blocks = (int)(need < (unsigned long long)fit ? need : fit);
  return cudaSuccess;
}

template <bool kCount>
int launch_pass(const float* q, const uint8_t* qmask, int n_problems, int nq,
                const float4* tp, const float* gbox, const float* tbox, int n_targets,
                int n_tiles, float thr2, void* scratch, int32_t* out_idx, float* out_d2,
                unsigned long long* counter, cudaStream_t stream) {
  const int n_qw = (nq + 31) / 32;
  const int per_target = n_problems / n_targets;
  // scratch: the list's count and a spare word (the warp boxes stay 16-byte
  // aligned), every problem's warp boxes (two float4 each), one key per
  // query and problem, then the list: room for every (problem, query warp,
  // tile), the dense grid's blocks
  unsigned long long* n_items = static_cast<unsigned long long*>(scratch);
  float4* wbox = reinterpret_cast<float4*>(n_items + 2);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(wbox + (size_t)2 * n_qw * n_problems);
  unsigned long long* list = keys + (size_t)nq * n_problems;
  const unsigned long long capacity = (unsigned long long)n_problems * n_qw * n_tiles;
  int blocks = 0;
  cudaError_t err = main_grid<kCount>(capacity, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(n_items, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  nn_seed_kernel<kCount><<<dim3((n_qw + kSeedWarps - 1) / kSeedWarps, n_problems),
                           kSeedWarps * 32, 0, stream>>>(
      q, qmask, nq, tp, gbox, tbox, n_tiles, per_target, thr2, keys, wbox, list, n_items,
      counter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_main_kernel<kCount><<<blocks, kMainWarps * 32, 0, stream>>>(
      q, qmask, nq, tp, gbox, tbox, n_tiles, per_target, thr2, keys, wbox, list, n_items,
      counter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_finish_kernel<<<dim3((nq + 255) / 256, n_problems), 256, 0, stream>>>(
      qmask, nq, keys, thr2, out_idx, out_d2);
  return (int)cudaGetLastError();
}

// The first warp design's pass: seed
// over every group box, then the dense main grid (4 query warps × one tile ×
// one problem a block).
int launch_pass_v1(const float* q, const uint8_t* qmask, int n_problems, int nq,
                   const float4* tp, const float* gbox, const float* tbox, int n_targets,
                   int n_tiles, float thr2, void* scratch, int32_t* out_idx, float* out_d2,
                   cudaStream_t stream) {
  const int n_qw = (nq + 31) / 32;
  const int blocks = (n_qw + kWarps - 1) / kWarps;
  const int per_target = n_problems / n_targets;
  // scratch: every problem's warp boxes (two float4 each), then one key per
  // query and problem
  float4* wbox = static_cast<float4*>(scratch);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(wbox + (size_t)2 * n_qw * n_problems);
  const int ng = n_tiles * 32;
  nn_seed_v1_kernel<<<dim3(blocks, n_problems), kWarps * 32, 0, stream>>>(
      q, qmask, nq, tp, gbox, ng, per_target, thr2, keys, wbox);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_main_v1_kernel<<<dim3(blocks, n_tiles, n_problems), kWarps * 32, 0, stream>>>(
      q, qmask, nq, tp, gbox, ng, tbox, n_tiles, per_target, thr2, keys, wbox);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_finish_kernel<<<dim3((nq + 255) / 256, n_problems), 256, 0, stream>>>(
      qmask, nq, keys, thr2, out_idx, out_d2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher returns the first error after its launches: a launch the
// card refuses never runs, and a later synchronize would not report it.

// The prep kernel over n_targets targets of nt points each (t (n_targets, nt,
// 3), tmask (n_targets, nt)): tp (n_targets, n_tiles·1024) float4, gbox
// (n_targets, 8, n_tiles·32) and tbox (n_targets, 8, n_tiles) f32, n_tiles =
// ⌈nt / 1024⌉ ≤ 65,535, n_targets ≤ 65,535.
int pctpu_nn_prep_batched(const float* t, const uint8_t* tmask, int64_t n_targets,
                          int64_t nt, void* tp, float* gbox, float* tbox, void* stream) {
  if (nt <= 0 || (nt + kTile - 1) / kTile > 65535 || n_targets <= 0 || n_targets > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((nt + kTile - 1) / kTile);
  nn_prep_kernel<<<dim3(n_tiles, (unsigned)n_targets), kTile, 0, (cudaStream_t)stream>>>(
      t, tmask, (int)nt, n_tiles, static_cast<float4*>(tp), gbox, tbox);
  return (int)cudaGetLastError();
}

// One target: the n_targets = 1 case.
int pctpu_nn_prep(const float* t, const uint8_t* tmask, int64_t nt, void* tp, float* gbox,
                  float* tbox, void* stream) {
  return pctpu_nn_prep_batched(t, tmask, 1, nt, tp, gbox, tbox, stream);
}

// One pass of n_problems problems (q (n_problems, nq, 3), qmask (n_problems,
// nq)) on n_targets prepared targets, n_problems a multiple of n_targets:
// the count's memset, seed, main and finish.  Problem p searches target p /
// (n_problems / n_targets).  scratch holds 2 + n_problems · (4·⌈nq / 32⌉ +
// nq + ⌈nq / 32⌉·n_tiles) 64-bit words; out_idx and out_d2 are (n_problems,
// nq).  With a counter (two 64-bit words), the counting instance adds 1,024
// pairs to counter[0] for every (warp, group) scanned and the list's items to
// counter[1].
int pctpu_nn_pruned_batched(const float* q, const uint8_t* qmask, int64_t n_problems,
                            int64_t nq, const void* tp, const float* gbox, const float* tbox,
                            int64_t n_targets, int64_t n_tiles, float thr2, void* scratch,
                            int32_t* out_idx, float* out_d2, void* counter, void* stream) {
  if (!pass_shape_ok(n_problems, nq, n_targets, n_tiles)) return (int)cudaErrorInvalidValue;
  const float4* pts = static_cast<const float4*>(tp);
  if (counter)
    return launch_pass<true>(q, qmask, (int)n_problems, (int)nq, pts, gbox, tbox,
                             (int)n_targets, (int)n_tiles, thr2, scratch, out_idx, out_d2,
                             static_cast<unsigned long long*>(counter), (cudaStream_t)stream);
  return launch_pass<false>(q, qmask, (int)n_problems, (int)nq, pts, gbox, tbox,
                            (int)n_targets, (int)n_tiles, thr2, scratch, out_idx, out_d2,
                            nullptr, (cudaStream_t)stream);
}

// One problem on one prepared target: the n_problems = n_targets = 1 case.
int pctpu_nn_pruned(const float* q, const uint8_t* qmask, int64_t nq, const void* tp,
                    const float* gbox, const float* tbox, int64_t n_tiles, float thr2,
                    void* scratch, int32_t* out_idx, float* out_d2, void* counter,
                    void* stream) {
  return pctpu_nn_pruned_batched(q, qmask, 1, nq, tp, gbox, tbox, 1, n_tiles, thr2, scratch,
                                 out_idx, out_d2, counter, stream);
}

// pctpu_nn_pruned_batched by the first warp design (seed, dense main grid,
// finish; no counting instance): scratch holds n_problems · (4·⌈nq / 32⌉ +
// nq) 64-bit words.
int pctpu_nn_pruned_batched_v1(const float* q, const uint8_t* qmask, int64_t n_problems,
                               int64_t nq, const void* tp, const float* gbox,
                               const float* tbox, int64_t n_targets, int64_t n_tiles,
                               float thr2, void* scratch, int32_t* out_idx, float* out_d2,
                               void* stream) {
  if (!pass_shape_ok(n_problems, nq, n_targets, n_tiles)) return (int)cudaErrorInvalidValue;
  return launch_pass_v1(q, qmask, (int)n_problems, (int)nq, static_cast<const float4*>(tp),
                        gbox, tbox, (int)n_targets, (int)n_tiles, thr2, scratch, out_idx,
                        out_d2, (cudaStream_t)stream);
}

}  // extern "C"
