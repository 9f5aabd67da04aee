// Hand-written Hopper kernels of the in-order segment sums, built by nvcc with
// the other sources of csrc/ into one shared library with a plain C interface
// (pctpu_torch/ops/_cuda.py) and launched through ctypes on PyTorch's
// current stream.
//
// Replaces the in-order scatter-adds that pctpu leaves to XLA: the voxel
// grid's per-voxel (x, y, z, count) sums (pctpu/ops/voxel.py:80) and the
// ground marking's per-sector (z sum, count) (pctpu/ops/ground.py:113).
//
// Contract (voxel.segment_sum_sorted, bit-equal to its twin
// segment_sum_sorted_reference): rows of L = 2 or 4 f32 lanes, row i being
// values[order[i]] (values[i] without an order); seg[i] is the row's
// segment, equal ids contiguous, an id outside [0, n_out) for a row that
// joins no segment.  out[s] = (((init + r1) + r2) + ...) over segment s's
// rows in row order, every add a correctly rounded f32 add, one chain per
// lane — the rounding sequence of a sequential scatter-add.  index_add_
// sums with atomics in an order that changes from run to run, and
// segment_reduce in a tree of its own; neither gives these bits.  Rows of
// out that no segment names hold init.
//
// What bounds it on the card: the bytes are few (≈ 12-20 B a row), and the
// one cost the contract makes serial is the chain of dependent adds of the
// longest segment (4 cycles an add).  So nothing but that chain may be
// serial, and no add may wait on device memory.
//
//   segment_fill_kernel writes init into every row of out.
//   segment_sum_tile_kernel, one warp per tile of 32 consecutive rows.  The
//     warp loads its rows and ids coalesced, with the id just before and
//     just after the tile.  A lane whose row opens a segment (a head) owns
//     that segment; its rows in the tile run to the next head or outside
//     row, found from two ballots.  In step j every head takes the j-th row
//     of its run by shuffle and adds it: each row is added once, in order,
//     heads of one tile add side by side, and the steps are as many as the
//     tile's longest run has rows (1-3 on the voxel grid; a head's first
//     row is its own and needs no shuffle).
//     The one segment that runs past the tile's end is carried on by the
//     same warp, every lane holding the same sums, through the following
//     tiles: a ring of kDepth tiles of rows (and the ids and row indices of
//     the kDepth after them) is kept in flight from device memory into the
//     warp's slice of shared memory by cp.async, and every lane reads a tile
//     back in 16-byte broadcast loads.  No add waits for device memory, and
//     the following tiles' own warps skip the rows before their first head.
//     Through an order a row is a gather of a 32-byte sector, so each row is
//     fetched once: by the tile of its head, or by the carry under the
//     segment's id.  Short voxel runs cost one tile; a sector of 1,750 rows
//     is 55 tiles.
//
// What the carry costs (H100, a lone segment of 17,500 rows): ≈ 9 ns a row,
// 17 cycles, not the 4 of its add chain — taking the adds out changes
// nothing.  A lone warp is slow at its memory instructions: ≈ 130 cycles
// a cp.async of 4-8 B a lane (three a tile: ids, indices, rows) and ≈ 10 a
// shared load.  That is why the carry reads whole tiles from shared memory:
// rows handed to every lane by shuffle cost one shuffle a lane and row (≈ 12
// cycles each, 24 cycles a row), and a ring kept in flight in registers
// shares the warp's six scoreboards, so that a wait for an old load also
// waits for the newest.
//
// No atomics, no tree, no fma: the result does not depend on how warps are
// scheduled, and two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 4;  // tiles of rows in flight while a warp carries a segment on
constexpr int kStep = 2;   // rows fetched by shuffle ahead of their adds: voxel runs are 1-3

template <int L>
struct Row {
  float v[L];
};

__device__ __forceinline__ Row<4> load_row(const Row<4>* __restrict__ values, int64_t r) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(values) + r);
  return {{x.x, x.y, x.z, x.w}};
}

__device__ __forceinline__ Row<2> load_row(const Row<2>* __restrict__ values, int64_t r) {
  const float2 x = __ldg(reinterpret_cast<const float2*>(values) + r);
  return {{x.x, x.y}};
}

__device__ __forceinline__ void store_row(Row<4>* __restrict__ out, int64_t r, const Row<4>& x) {
  reinterpret_cast<float4*>(out)[r] = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
}

__device__ __forceinline__ void store_row(Row<2>* __restrict__ out, int64_t r, const Row<2>& x) {
  reinterpret_cast<float2*>(out)[r] = make_float2(x.v[0], x.v[1]);
}

template <int L>
__device__ __forceinline__ void add_row(Row<L>& acc, const Row<L>& x) {
#pragma unroll
  for (int l = 0; l < L; ++l) acc.v[l] = __fadd_rn(acc.v[l], x.v[l]);
}

template <int L>
__device__ __forceinline__ Row<L> shfl_row(const Row<L>& x, int lane) {
  Row<L> y;
#pragma unroll
  for (int l = 0; l < L; ++l) y.v[l] = __shfl_sync(kFull, x.v[l], lane);
  return y;
}

// Heads add side by side: acc += this lane's run of `count` rows (0 for a
// lane that is no head), which starts at the lane's own row, held in x.  The
// first row is the lane's own; row j of every run comes by shuffle from lane
// + j, kStep rows ahead of their adds, for as long as any run has rows left.
// Every lane of the warp must call it.
template <int L>
__device__ __forceinline__ void add_runs(Row<L>& acc, const Row<L>& x, int lane, int count) {
  if (count > 0) add_row(acc, x);
  for (int j0 = 1; __any_sync(kFull, j0 < count); j0 += kStep) {
    Row<L> xs[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j) xs[j] = shfl_row(x, lane + j0 + j);
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
#pragma unroll
      for (int l = 0; l < L; ++l)
        acc.v[l] = j0 + j < count ? __fadd_rn(acc.v[l], xs[j].v[l]) : acc.v[l];
    }
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's ring in shared memory while it carries a segment on: the rows of
// kDepth tiles, the row indices of the kDepth tiles after those, and the ids
// of all 2·kDepth.  Tile k sits in slot k mod the ring's length.
template <int L>
struct Ring {
  float4 rows[kDepth][32 * L / 4];
  int64_t src[kDepth][32];
  int32_t id[2 * kDepth][32];
};

// acc += rows 0 .. count - 1 of a tile in shared memory, in order, for every
// lane alike: 16-byte broadcast loads of 4 / L rows each, which the compiler
// is free to start ahead of the adds.
template <int L>
__device__ __forceinline__ void add_staged_rows(Row<L>& acc, const float4* tile, int count) {
  if (count == 32) {
#pragma unroll
    for (int q = 0; q < 32 * L / 4; ++q) {
      const float4 r = tile[q];
      acc.v[0] = __fadd_rn(acc.v[0], r.x);
      acc.v[1] = __fadd_rn(acc.v[1], r.y);
      acc.v[2 % L] = __fadd_rn(acc.v[2 % L], r.z);
      acc.v[3 % L] = __fadd_rn(acc.v[3 % L], r.w);
    }
  } else {
    const Row<L>* rows = reinterpret_cast<const Row<L>*>(tile);
    for (int k = 0; k < count; ++k) add_row(acc, rows[k]);
  }
}

template <int L>
__global__ void segment_fill_kernel(Row<L> init, int64_t n_out, Row<L>* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n_out) store_row(out, i, init);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    segment_sum_tile_kernel(const Row<L>* __restrict__ values, const int64_t* __restrict__ order,
                            const int32_t* __restrict__ seg, int64_t n, int64_t n_out,
                            Row<L> init, Row<L>* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t base = ((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5) * 32;
  if (base >= n) return;  // the whole warp
  const int64_t i = base + lane;
  const int32_t id = i < n ? seg[i] : -1;
  int32_t edge = -1;  // lane 0: the id just before the tile; lane 31: just after it
  if (lane == 0 && base > 0) edge = seg[base - 1];
  if (lane == 31 && base + 32 < n) edge = seg[base + 32];
  const bool joins = id >= 0 && id < n_out;
  // without an order a row's address waits for nothing; through an order a
  // row is a gather of its own, fetched below only where a head will add it
  int64_t src = i;
  if (order && i < n) src = order[i];
  Row<L> x = {};
  if (!order && i < n) x = load_row(values, i);

  int32_t before = __shfl_up_sync(kFull, id, 1);
  if (lane == 0) before = edge;
  const bool head = joins && id != before;
  const unsigned heads = __ballot_sync(kFull, head);
  if (heads == 0) return;  // rows of a segment carried from an earlier tile, or of none
  if (order && joins && lane >= __ffs(heads) - 1) x = load_row(values, src);

  // a head's rows in this tile are [lane, end): up to the next head or outside row
  const unsigned stops = heads | ~__ballot_sync(kFull, joins);
  const unsigned above = stops & ~((2u << lane) - 1u);
  const int end = above ? __ffs(above) - 1 : 32;
  Row<L> acc = init;
  add_runs(acc, x, lane, head ? end - lane : 0);

  // the last head's segment runs on when it reaches the tile's end and the
  // next tile opens with its id
  const int last = 31 - __clz(heads);
  const bool runs_on = (stops & ~((2u << last) - 1u)) == 0 &&
                       __any_sync(kFull, lane == 31 && id == edge);
  if (head && !(runs_on && lane == last)) store_row(out, id, acc);
  if (!runs_on) return;

  // carry: every lane holds the same sums.  The following tiles come
  // through the warp's ring by cp.async, which waits on its own groups and
  // not on the warp's few scoreboards: iteration k waits for the group that
  // holds tile k's rows, adds them, and commits the next group — the rows of
  // tile k + kDepth, fetched only under the segment's id, and the id and
  // row index of tile k + 2·kDepth.  A lane copies its own id and index and
  // reads them back itself; rows are read by all after __syncwarp.
  const int32_t cid = __shfl_sync(kFull, id, last);
  acc = shfl_row(acc, last);
  __shared__ __align__(16) Ring<L> rings[kWarps];
  Ring<L>& ring = rings[threadIdx.x >> 5];
  const int64_t first = base + 32 + lane;  // this lane's row of tile 0
  auto fetch_id = [&](int64_t k) {  // the id and the row index of tile k
    const int64_t j = first + 32 * k;
    int32_t* id_slot = &ring.id[k % (2 * kDepth)][lane];
    if (j < n) {
      cp_async<4>(id_slot, seg + j);
      if (order) cp_async<8>(&ring.src[k % kDepth][lane], order + j);
    } else {
      *id_slot = -1;
    }
  };
  auto fetch_row = [&](int64_t k) {  // this lane's row of tile k, if the segment's
    if (ring.id[k % (2 * kDepth)][lane] != cid) return;
    const int64_t j = order ? ring.src[k % kDepth][lane] : first + 32 * k;
    cp_async<4 * L>(reinterpret_cast<Row<L>*>(ring.rows[k % kDepth]) + lane, values + j);
  };
  for (int k = 0; k < kDepth; ++k) fetch_id(k);
  cp_async_commit();
  cp_async_wait<0>();
  for (int k = 0; k < kDepth; ++k) {
    fetch_row(k);
    fetch_id(k + kDepth);
    cp_async_commit();
  }
  for (int64_t k = 0;; ++k) {
    cp_async_wait<kDepth - 1>();  // tile k's rows, and with them tile k + kDepth's ids
    __syncwarp();
    // the segment's rows open the tile: count them
    const unsigned others = ~__ballot_sync(kFull, ring.id[k % (2 * kDepth)][lane] == cid);
    const int cnt = others ? __ffs(others) - 1 : 32;
    add_staged_rows(acc, ring.rows[k % kDepth], cnt);
    if (cnt < 32) break;
    __syncwarp();  // every lane has read the slot that tile k + kDepth's rows go into
    fetch_row(k + kDepth);
    fetch_id(k + 2 * kDepth);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (lane == 0) store_row(out, cid, acc);
}

template <int L>
int launch(const float* values, const int64_t* order, const int32_t* seg,
           int64_t n, const float* init4, float* out, int64_t n_out, int fill,
           cudaStream_t stream) {
  Row<L> init;
  for (int l = 0; l < L; ++l) init.v[l] = init4[l];
  const Row<L>* v = reinterpret_cast<const Row<L>*>(values);
  Row<L>* o = reinterpret_cast<Row<L>*>(out);
  if (fill) {
    segment_fill_kernel<L><<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0,
                             stream>>>(init, n_out, o);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  segment_sum_tile_kernel<L><<<blocks, kThreads, 0, stream>>>(v, order, seg, n, n_out, init, o);
  return (int)cudaGetLastError();
}

int dispatch(const float* values, const int64_t* order, const int32_t* seg,
             int64_t n, int lanes, const float* init4, float* out, int64_t n_out, int fill,
             void* stream) {
  if (n <= 0 || n_out <= 0 || n >= (1ll << 31) || n_out >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 4) return launch<4>(values, order, seg, n, init4, out, n_out, fill, s);
  if (lanes == 2) return launch<2>(values, order, seg, n, init4, out, n_out, fill, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launches.  values: rows of
// `lanes` (2 or 4) floats, aligned to a row; order: n row indices or null;
// seg: n ids; out: n_out rows; fill != 0 writes init into every row of out
// first (without it, rows that no segment names are left as they were).

int pctpu_segment_sum(const float* values, const int64_t* order, const int32_t* seg, int64_t n,
                      int lanes, float i0, float i1, float i2, float i3, float* out,
                      int64_t n_out, int fill, void* stream) {
  const float init4[4] = {i0, i1, i2, i3};
  return dispatch(values, order, seg, n, lanes, init4, out, n_out, fill, stream);
}

}  // extern "C"
