"""pctpu_torch's CUDA kernels against their plain torch twins, on the card.

Tests per kernel, each marked ``cuda``: they skip where there is no
NVIDIA card (a CUDA kernel has no CPU mode; the twins are held against
pctpu by the other ``test_torch_*`` files).  This file imports neither jax
nor pctpu, so it runs on the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX.)  Every kernel must
agree with its twin in every index and every float bit."""

import numpy as np
import pytest
import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.config import MultiBevConfig, SensorParams, SingleBevConfig
from pctpu_torch.experiments.scene import multi_bev_tree
from pctpu_torch.ops import bev, ground, ordering
from pctpu_torch.ops import cuda_knn as tk
from pctpu_torch.ops import voxel


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cloud(rng, n, dev, span=60.0, drop=0.05):
    xyz = torch.from_numpy(rng.uniform(-span, span, (n, 3)).astype(np.float32)).to(dev)
    return xyz, torch.from_numpy(rng.random(n) >= drop).to(dev)


def _sorted_scene(dev):
    rng = np.random.default_rng(6)
    return (tk.spatial_sort_payload(*_cloud(rng, 20000, dev))
            + tk.spatial_sort_payload(*_cloud(rng, 30000, dev)))


def _bit_equal(got, want) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


@pytest.mark.cuda
def test_nn_pruned(dev):
    args = _sorted_scene(dev)
    for md in (2.0, None):
        assert _bit_equal(tk.nn_1_pruned(*args, max_distance=md),
                          tk.nn_1_pruned_reference(*args, max_distance=md)), md


def _ties(dev):
    """Equal distances across groups and tiles: duplicates of one point at
    indices 5, 40 (another group) and 1500 (another tile), its mirror image
    at 1200."""
    t = torch.full((2100, 3), 50.0)
    t[5] = t[40] = t[1500] = torch.tensor([1.0, 2.0, 3.0])
    t[1200] = torch.tensor([-1.0, -2.0, -3.0])
    q = torch.zeros((37, 3))
    q[1] = torch.tensor([1.0, 2.0, 3.5])
    tm = torch.ones(2100, dtype=torch.bool)
    tm[5] = False
    return q.to(dev), torch.ones(37, dtype=torch.bool, device=dev), t.to(dev), tm.to(dev)


def _dirty(q, t, tm):
    """Copies of sorted queries and targets with NaN and infinite
    coordinates: NaN in valid targets (one of them in a group and a tile of
    its own's neighbours) and in a masked one, ±inf in valid targets, a NaN
    and an infinite query.  A NaN target is never found and costs no other
    target anything, in the kernels and in the twin (ROADMAP F13, README
    D23)."""
    q, t, tm = q.clone(), t.clone(), tm.clone()
    t[100, 1] = t[2500, 0] = t[2501, 2] = float("nan")
    t[4000, 0], t[8000, 2] = float("inf"), -float("inf")
    tm[[100, 2500, 2501, 4000, 8000]] = True
    t[300, 0] = float("nan")
    tm[300] = False
    q[5, 2], q[9, 0], q[40, 1] = float("nan"), float("inf"), -float("inf")
    return q, t, tm


def _warp_cases(dev):
    """(name, (query, query_mask, target, target_mask)) of the warp design's
    edge cases; the sorted ones through spatial_sort_payload."""
    rng = np.random.default_rng(9)
    q, qm, t, tm = _sorted_scene(dev)
    bad_q, bad_t, bad_tm = _dirty(q, t, tm)
    big_t, big_tm = tk.spatial_sort_payload(*_cloud(rng, 300_000, dev, 100.0))
    big_q, big_qm = tk.spatial_sort_payload(*_cloud(rng, 5_000, dev, 100.0))
    ragged = 3 * 1024 + 32 * 5 + 7  # T not a multiple of 32 or 1,024
    return [
        ("sorted", (q, qm, t, tm)),
        ("ties across groups and tiles", _ties(dev)),
        ("all-masked target", (q, qm, t, torch.zeros_like(tm))),
        ("all-masked queries", (q, torch.zeros_like(qm), t, tm)),
        ("Q = 1", (q[:1], torch.ones(1, dtype=torch.bool, device=dev), t, tm)),
        ("Q = 1,000 (not a multiple of 32)", (q[:1000], qm[:1000], t, tm)),
        ("T = 1", (q, qm, t[:1], torch.ones(1, dtype=torch.bool, device=dev))),
        ("T ragged", (q, qm, t[:ragged], tm[:ragged])),
        ("T > 262,144", (big_q, big_qm, big_t, big_tm)),
        ("unsorted", (*_cloud(rng, 3000, dev), *_cloud(rng, 7000, dev))),
        ("queries far outside the target's box", (q + 1000.0, qm, t, tm)),
        ("NaN and inf coordinates, NaN in valid targets", (bad_q, qm, bad_t, bad_tm)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("md", [None, 2.0, 1e-3])
def test_nn_pruned_warp_cases(dev, md):
    """The warp design against its twin, bit for bit, with and without a
    prepared target, and against the earlier block design."""
    for name, args in _warp_cases(dev):
        want = tk.nn_1_pruned_reference(*args, max_distance=md)
        prep = tk.prepare_target(args[2], args[3])
        assert _bit_equal(tk.nn_1_pruned(*args, max_distance=md), want), (name, md)
        assert _bit_equal(tk.nn_1_pruned(*args[:2], max_distance=md, prepared=prep),
                          want), (name, md)
        assert _bit_equal(tk.nn_1_pruned_variant_v1(*args, md, tk.TQ, tk.TT, "prod"), want), (name, md)
        visited = tk.pairs_visited(args[0], args[1], prep, md)
        assert 0 <= visited <= 1024 * -(-args[0].shape[0] // 32) * (prep.packed.shape[0] // 32 + 1)


@pytest.mark.cuda
def test_nn_prep(dev):
    """The prep kernel against its twin: packed points, group and tile boxes,
    bit for bit (−0 coordinates included, an all-masked group, and NaN
    coordinates in valid and masked points, which the boxes leave out)."""
    rng = np.random.default_rng(10)
    for n in (1, 31, 1024, 5000):
        xyz, mask = _cloud(rng, n, dev)
        xyz[: min(n, 7)] = -0.0
        mask[min(n, 64):min(n, 128)] = False
        if n == 5000:
            xyz[[10, 2000, 2001, 4500], [0, 1, 2, 0]] = float("nan")
            mask[[10, 2000, 2001]] = True
            mask[4500] = False
        got = tk.prepare_target(xyz, mask)
        want = tk.prepare_target_reference(xyz, mask)
        assert got.n == want.n == n
        for a, b in ((got.packed, want.packed), (got.group_box, want.group_box),
                     (got.tile_box, want.tile_box)):
            assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32)), n


def _batched_cases(dev):
    """(name, queries (P, Q, 3), masks, targets (Bt, T, 3), masks) for the
    batched pass: ragged valid counts, a target with no valid point, shared
    targets (P > Bt), P = 1, ties across groups and tiles, and NaN in valid
    targets."""
    rng = np.random.default_rng(21)

    def batch(n_problems, n_targets, nq, nt):
        q = torch.stack([tk.spatial_sort_payload(*_cloud(rng, nq, dev))[0]
                         for _ in range(n_problems)])
        t = torch.stack([tk.spatial_sort_payload(*_cloud(rng, nt, dev))[0]
                         for _ in range(n_targets)])
        qm = torch.from_numpy(rng.random((n_problems, nq)) >= 0.05).to(dev)
        tm = torch.from_numpy(rng.random((n_targets, nt)) >= 0.05).to(dev)
        qm[0, nq // 3:] = False
        tm[0, nt // 2:] = False
        if n_targets > 1:
            tm[-1] = False
        return q, qm, t, tm

    ties = _ties(dev)
    q, qm, t, tm = batch(4, 2, 3000, 9000)
    dirty = [_dirty(q[k], t[k // 2], tm[k // 2]) for k in range(4)]
    return [
        ("NaN and inf coordinates, NaN in valid targets",
         (torch.stack([d[0] for d in dirty]), qm,
          torch.stack([dirty[0][1], dirty[2][1]]), torch.stack([dirty[0][2], dirty[2][2]]))),
        ("16 problems, 16 targets", batch(16, 16, 3000, 5000)),
        ("32 problems sharing 16 targets", batch(32, 16, 2000, 4100)),
        ("6 problems sharing 2 targets", batch(6, 2, 777, 3 * 1024 + 5)),
        ("P = 1", batch(1, 1, 4000, 9000)),
        ("ties, 3 problems on 1 target", (ties[0].expand(3, -1, -1).contiguous(),
                                           ties[1].expand(3, -1).contiguous(),
                                           ties[2][None].contiguous(), ties[3][None].contiguous())),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("md", [None, 2.0])
def test_nn_pruned_batched(dev, md):
    """The batched prep and pass (one prep launch, three pass launches) bit
    for bit against P unbatched kernel calls and against the twin."""
    for name, (q, qm, t, tm) in _batched_cases(dev):
        n_problems, n_targets = q.shape[0], t.shape[0]
        per = n_problems // n_targets
        prep = tk.prepare_targets(t, tm)
        ref = tk.prepare_targets_reference(t, tm)
        assert _bit_equal([prep.packed, prep.group_box, prep.tile_box],
                          [ref.packed, ref.group_box, ref.tile_box]), name
        got = tk.nn_1_pruned_batched(q, qm, prep, md)
        twin = tk.nn_1_pruned_batched_reference(q, qm, t, tm, md)
        assert _bit_equal(got, twin), name
        for b in range(n_targets):
            one = tk.prepare_target(t[b], tm[b])
            assert _bit_equal([one.packed, one.group_box, one.tile_box],
                              [prep.packed[b], prep.group_box[b], prep.tile_box[b]]), name
        for k in range(n_problems):
            single = tk.nn_1_pruned(q[k], qm[k], prepared=tk.prepare_target(
                t[k // per], tm[k // per]), max_distance=md)
            assert _bit_equal([got[0][k], got[1][k]], single), (name, k)
        torch.cuda.synchronize()
    with pytest.raises(ValueError):
        tk.nn_1_pruned_batched(q[:2], qm[:2], tk.prepare_targets(t.repeat(3, 1, 1),
                                                                  tm.repeat(3, 1)))


def _problem_batch(args, n_problems, n_targets):
    """One of K1's edge cases as P problems on Bt targets: problem k keeps
    the case's queries with every (k + 1)-th further masked (problem 0 as it
    is), target b the case's target with every (b + 2)-th further masked."""
    q, qm, t, tm = args
    rows_q = torch.arange(q.shape[0], device=q.device)
    rows_t = torch.arange(t.shape[0], device=t.device)
    qms = [qm if k == 0 else qm & (rows_q % (k + 1) != 0) for k in range(n_problems)]
    tms = [tm if b == 0 else tm & (rows_t % (b + 2) != 1) for b in range(n_targets)]
    return (q.expand(n_problems, -1, -1).contiguous(), torch.stack(qms),
            t.expand(n_targets, -1, -1).contiguous(), torch.stack(tms))


@pytest.mark.cuda
@pytest.mark.parametrize("md", [None, 2.0, 1e-3])
@pytest.mark.parametrize("n_problems,n_targets", [(1, 1), (2, 2), (16, 16), (32, 16)])
def test_nn_pruned_batched_new_v1_twin(dev, md, n_problems, n_targets):
    """The work-list design, the first warp design (``nn_1_pruned_batched_v1``)
    and the twin, bit for bit, over K1's edge cases as P problems on Bt
    targets (problem p on target p // (P / Bt)); at P = 1 the single entry
    too, and the list never holds more than the dense grid's blocks."""
    for name, args in _warp_cases(dev):
        q, qm, t, tm = _problem_batch(args, n_problems, n_targets)
        prep = tk.prepare_targets(t, tm)
        want = tk.nn_1_pruned_batched_reference(q, qm, t, tm, md)
        assert _bit_equal(tk.nn_1_pruned_batched(q, qm, prep, md), want), (name, md)
        assert _bit_equal(tk.nn_1_pruned_batched_v1(q, qm, prep, md), want), (name, md, "v1")
        if n_problems == 1:
            one = tk.prepare_target(t[0], tm[0])
            assert _bit_equal(tk.nn_1_pruned(q[0], qm[0], prepared=one, max_distance=md),
                              [want[0][0], want[1][0]]), (name, md)
            assert _bit_equal(tk.nn_1_pruned_batched_v1(q[0], qm[0], one, md),
                              [want[0][0], want[1][0]]), (name, md, "v1")
        pairs, items = tk.pass_counts(q, qm, prep, md)
        tiles = prep.tile_box.shape[-1]
        assert 0 <= items <= n_problems * -(-q.shape[1] // 32) * tiles, name
        assert 0 <= pairs <= 1024 * n_problems * -(-q.shape[1] // 32) * (32 * tiles + 1), name
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_problems,n_targets", [(1, 1), (16, 16), (32, 16)])
def test_nn_pruned_work_list_empty_and_full(dev, n_problems, n_targets):
    """A pass whose list is empty (every tile beyond thr: queries 1 km away,
    thr 2 m) and one whose list is full (unsorted clouds, no thr: every
    query warp's box overlaps every tile's), each bit-equal to the twin and
    the first design."""
    rng = np.random.default_rng(31)
    q, qm, t, tm = _sorted_scene(dev)
    unsorted = (*_cloud(rng, 3000, dev), *_cloud(rng, 7000, dev))
    for args, md, full in (((q + 1000.0, qm, t, tm), 2.0, False), (unsorted, None, True)):
        bq, bqm, bt, btm = _problem_batch(args, n_problems, n_targets)
        prep = tk.prepare_targets(bt, btm)
        want = tk.nn_1_pruned_batched_reference(bq, bqm, bt, btm, md)
        assert _bit_equal(tk.nn_1_pruned_batched(bq, bqm, prep, md), want), full
        assert _bit_equal(tk.nn_1_pruned_batched_v1(bq, bqm, prep, md), want), full
        items = tk.pass_counts(bq, bqm, prep, md)[1]
        dense = n_problems * -(-bq.shape[1] // 32) * prep.tile_box.shape[-1]
        assert items == (dense if full else 0), (full, items, dense)
        if not full:
            assert not torch.isfinite(want[1]).any()


def _variant_twin(mode):
    return tk.nn_1_pruned_bf16_reference if mode == "bf16" else tk.nn_1_pruned_reference


@pytest.mark.cuda
def test_nn_variant(dev):
    """Every instance, in the new design (csrc/nn_variant.cu) and the first
    (csrc/nn_pruned.cu), against its twin, bit for bit."""
    args = _sorted_scene(dev)
    for tq, tt, mode in sorted(tk.VARIANTS):
        for md in (2.0, None):
            want = _variant_twin(mode)(*args, max_distance=md)
            assert _bit_equal(tk.nn_1_pruned_variant(*args, md, tq, tt, mode),
                              want), (tq, tt, mode, md)
            assert _bit_equal(tk.nn_1_pruned_variant_v1(*args, md, tq, tt, mode),
                              want), (tq, tt, mode, md, "v1")


def _variant_cases(dev):
    """(name, (query, query_mask, target, target_mask)) of the variants'
    edge cases.  The NaN case puts NaN in queries, in valid targets and in
    a masked one: a NaN d² never wins, in the kernels' strict < and in the
    twin (ROADMAP F13, README D23)."""
    rng = np.random.default_rng(13)
    q, qm, t, tm = _sorted_scene(dev)
    short_t, short_tm = tk.spatial_sort_payload(*_cloud(rng, 700, dev))
    ragged = 2 * 4096 + 3 * 1024 + 32 * 5 + 7  # T no multiple of 32, 1,024 or 4,096
    bad_q, bad_t = q[:3000].clone(), t[:ragged].clone()
    bad_q[5, 2] = float("nan")
    bad_q[9, 0] = float("inf")
    bad_q[40, 1] = -float("inf")
    bad_t[100, 1] = float("nan")
    bad_t[4000, 0] = float("inf")
    bad_t[8000, 2] = -float("inf")
    bad_t[3000, 0] = float("nan")
    bad_tm = torch.ones(ragged, dtype=torch.bool, device=dev)
    bad_tm[3000] = False
    return [
        ("T < tt", (q, qm, short_t, short_tm)),
        ("T ragged", (q, qm, t[:ragged], tm[:ragged])),
        ("all-masked queries", (q, torch.zeros_like(qm), t, tm)),
        ("all-masked target", (q, qm, t, torch.zeros_like(tm))),
        ("ties across groups and tiles", _ties(dev)),
        ("Q = 1", (q[:1], torch.ones(1, dtype=torch.bool, device=dev), t, tm)),
        ("NaN and inf coordinates", (bad_q, torch.ones(3000, dtype=torch.bool, device=dev),
                                     bad_t, bad_tm)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("md", [None, 2.0])
def test_nn_variant_cases(dev, md):
    """The edge cases through every instance, new design and first, against
    the twin bit for bit."""
    for name, args in _variant_cases(dev):
        twins = {mode: _variant_twin(mode)(*args, max_distance=md)
                 for mode in ("prod", "bf16")}
        for tq, tt, mode in sorted(tk.VARIANTS):
            want = twins["bf16" if mode == "bf16" else "prod"]
            assert _bit_equal(tk.nn_1_pruned_variant(*args, md, tq, tt, mode),
                              want), (name, tq, tt, mode, md)
            assert _bit_equal(tk.nn_1_pruned_variant_v1(*args, md, tq, tt, mode),
                              want), (name, tq, tt, mode, md, "v1")
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_nn_variant_prep(dev):
    """The new design's prep at every compiled (tt, bf16) against its twin
    bit for bit: −0 coordinates, a masked group and a
    fully masked tile, T below, at and past a tile."""
    rng = np.random.default_rng(14)
    for n in (1, 1000, 4096, 9000):
        xyz, mask = _cloud(rng, n, dev)
        xyz[: min(n, 7)] = -0.0
        mask[min(n, 64):min(n, 128)] = False
        mask[min(n, 4096):min(n, 8192)] = False
        for tt, bf16 in sorted(tk.VARIANT_PREPS):
            got = tk.prepare_variant_target(xyz, mask, tt, bf16)
            want = tk.prepare_target_reference(xyz, mask, tt, bf16)
            assert got.n == want.n == n
            assert got.packed.dtype == want.packed.dtype
            for a, b in ((got.packed, want.packed), (got.group_box, want.group_box),
                         (got.tile_box, want.tile_box)):
                assert a.shape == b.shape, (n, tt, bf16)
                bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
                assert torch.equal(a.view(bits), b.view(bits)), (n, tt, bf16)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_nn_variant_tq1024_launches(dev):
    """The instances of 1,024-query blocks (32 warps, 64 registers a thread)
    launch, on a grid of many such blocks, and count one pass each: a launch
    the card refuses raises from its wrapper."""
    from pctpu_torch.ops import _cuda

    rng = np.random.default_rng(15)
    args = (*tk.spatial_sort_payload(*_cloud(rng, 40000, dev)),
            *tk.spatial_sort_payload(*_cloud(rng, 40000, dev)))
    want = tk.nn_1_pruned_reference(*args, max_distance=2.0)
    wide = sorted(v for v in tk.VARIANTS if v[0] == 1024)
    assert wide
    for tq, tt, mode in wide:
        before = _cuda.launch_counts["nn_variant"]
        got = tk.nn_1_pruned_variant(*args, 2.0, tq, tt, mode)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["nn_variant"] == before + 1
        assert _bit_equal(got, want), (tq, tt, mode)


def _fused_cases(dev):
    """(name, (query, query_mask, target, target_mask)) of the fused 1-NN's
    edge cases."""
    rng = np.random.default_rng(4)
    cases = [(f"Q = {nq}, T = {nt}", (*_cloud(rng, nq, dev, 70.0), *_cloud(rng, nt, dev, 70.0)))
             for nq, nt in ((3000, 9000), (1, 1), (255, 257), (256, 256), (257, 255), (1, 9000),
                            (3000, 1), (9000, 3000))]
    q, qm, t, tm = cases[0][1]
    cases.append(("all targets masked", (q, qm, t, torch.zeros_like(tm))))
    cases.append(("all queries masked", (q, torch.zeros_like(qm), t, tm)))
    # duplicates in one chunk, one tile, and tiles apart (other splits)
    dup = t.clone()
    dup[[40, 45, 300, 2000, 8999]] = dup[7].clone()
    on_targets = torch.cat([dup[[7, 45, 8999]], q[:200]])
    cases.append(("duplicate targets", (on_targets, torch.ones(203, dtype=torch.bool, device=dev),
                                        dup, tm | (torch.arange(9000, device=dev) == 7))))
    masked_first = tm.clone()
    masked_first[[7, 40]] = False
    cases.append(("duplicate targets, the first two masked", (on_targets, qm[:203], dup,
                                                              masked_first)))
    # mirrored about the query: equal scores from different coordinates
    mirror = torch.full((2100, 3), 50.0, device=dev)
    mirror[1200] = torch.tensor([-1.0, -2.0, -3.0])
    mirror[1500] = torch.tensor([1.0, 2.0, 3.0])
    zero_q = torch.zeros((37, 3), device=dev)
    ones = torch.ones(37, dtype=torch.bool, device=dev)
    cases.append(("mirrored targets", (zero_q, ones, mirror,
                                       torch.ones(2100, dtype=torch.bool, device=dev))))
    # scores of +0 and -0 terms: targets at +0 and -0, queries with -0 coordinates
    zeros = mirror.clone()
    zeros[3] = -0.0
    zeros[600] = 0.0
    zeros[1700] = -0.0
    cases.append(("signed-zero scores", (-zero_q, ones, zeros,
                                         torch.ones(2100, dtype=torch.bool, device=dev))))
    # NaN and infinite coordinates, unmasked, and a NaN and an infinite query
    bad_t, bad_q = t.clone(), q.clone()
    bad_t[100, 1] = float("nan")
    bad_t[4000, 0] = float("inf")
    bad_t[8000, 2] = -float("inf")
    bad_q[7, 2] = float("nan")
    bad_q[9, 0] = float("inf")
    every = torch.ones_like(tm)
    cases.append(("NaN and inf coordinates", (bad_q, torch.ones_like(qm), bad_t, every)))
    return cases


@pytest.mark.cuda
def test_nn_fused(dev):
    """new = first design = twin, bit for bit, at the splits the C side
    picks and at fixed ones (1, 3, one a tile), and a second run; the prep
    kernel's packed target against its twin."""
    for name, args in _fused_cases(dev):
        want = tk.nn_1_fused_reference(*args)
        got = tk.nn_1_fused(*args)
        assert _bit_equal(got, want), name
        assert _bit_equal(tk.nn_1_fused_v1(*args), want), name
        assert _bit_equal(tk.nn_1_fused(*args), got), name
        for splits in (1, 3, 1 << 15):
            launch, idx, packed = tk._fused_launcher(*args, splits=splits)
            launch()
            assert torch.equal(idx, want[0]), (name, splits)
        ref = tk.prepare_fused_target_reference(args[2], args[3])
        assert packed.shape == ref.shape, name
        # bit for bit, but a NaN is a NaN whatever its payload
        same = (packed.view(torch.int32) == ref.view(torch.int32)) | (packed.isnan() & ref.isnan())
        assert bool(same.all()), name
        assert tk.fused_grid(args[0].shape[0], args[2].shape[0])[1] >= 1


def _segment_rows(lengths, gaps, lanes, rng, dev):
    """Runs of ``lengths`` rows under ascending ids (some ids name no row),
    ``gaps[k]`` rows of -1 before run k and ``gaps[-1]`` after the last;
    values spanning 1e-3..1e3, so that the order of the adds changes bits."""
    seg, sid = [], 0
    for k, n in enumerate(lengths):
        seg += [-1] * gaps[k] + [sid] * n
        sid += 1 + k % 3
    seg = np.array(seg + [-1] * gaps[len(lengths)], np.int32)
    vals = (rng.normal(size=(len(seg), lanes))
            * 10.0 ** rng.integers(-3, 4, (len(seg), 1))).astype(np.float32)
    return torch.from_numpy(vals).to(dev), torch.from_numpy(seg).to(dev), sid + 2


def _segment_cases():
    """(name, run lengths, rows of -1 before each run and after the last)."""
    lengths = [1, 31, 32, 33, 64, 65, 2000]
    return [
        ("tile lengths", lengths, [0] * 8),
        ("outside rows at the front, inside and at the end", lengths, [3, 0, 1, 0, 40, 0, 2, 5]),
        # rows 31..64: opens on lane 31 of tile 0, closes on lane 0 of tile 2
        ("from lane 31 to lane 0", [31, 34, 5], [0] * 4),
        ("a run across four tiles, then single rows", [20, 100] + [1] * 40, [0] * 43),
        ("n not a multiple of 32", [7, 50, 3], [0, 0, 0, 1]),
        ("n = 1", [1], [0, 0]),
        ("one row after outside rows", [1], [45, 0]),
        ("all rows outside", [], [77]),
        ("one segment", [5000], [0, 0]),
    ]


def _hold_segment_sums(values, seg, init, n_out, order=None):
    """new = walk = twin, bit for bit, and a second run of the new kernel."""
    want = voxel.segment_sum_sorted_reference(values, seg, init, n_out, order)
    got = voxel.segment_sum_sorted(values, seg, init, n_out, order)
    assert _bit_equal([got], [want])
    assert _bit_equal([voxel.segment_sum_walk(values, seg, init, n_out, order)], [want])
    assert _bit_equal([voxel.segment_sum_sorted(values, seg, init, n_out, order)], [got])


@pytest.mark.cuda
def test_segment_sum4(dev):
    rng = np.random.default_rng(7)
    xyz, mask = _cloud(rng, 40000, dev, 30.0)
    values, seg, _ = voxel.voxel_segments(xyz, mask, 0.2)
    _hold_segment_sums(values, seg, None, None)
    for name, lengths, gaps in _segment_cases():
        for init in (None, (0.5, -2.0, 1e-3, 100.0)):
            values, seg, n_out = _segment_rows(lengths, gaps, 4, rng, dev)
            _hold_segment_sums(values, seg, init, n_out)
            _hold_segment_sums(values, seg, init, max(n_out // 2, 1))  # ids past the output


def _labeled_batch(dev, tmp_path):
    """Four ordered, ground-marked clouds of a small ray-cast drive."""
    from pctpu_torch.io.pcd import load_cloud_pcd

    params = SensorParams(16, 512, 10, 0.5)
    paths = multi_bev_tree(str(tmp_path), params, n_ordered=0, n_raw=4, n_over=0, seed=2)
    clouds = [load_cloud_pcd(p, capacity=params.grid_size + 1024, device=dev) for p in paths]
    batch = clouds[0].replace(
        count=torch.tensor([c.count for c in clouds], device=dev),
        **{k: torch.stack([getattr(c, k) for c in clouds])
           for k in ("xyz", "intensity", "row", "col", "t", "label")})
    return params, ordering.get_ordered_cloud(batch, params)


def _hold_rasters(cloud, height_res, *cfgs):
    """new = first design = twin, byte for byte, and a second run.  Returns
    the rasters."""
    want = bev.fused_multi_single_bev_reference(cloud, height_res, *cfgs)
    got = bev.fused_multi_single_bev(cloud, height_res, *cfgs)
    for other in (got, bev.fused_multi_single_bev_v1(cloud, height_res, *cfgs),
                  bev.fused_multi_single_bev(cloud, height_res, *cfgs)):
        assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(other, want))
    # a warp's equal cells combined: never more atomics than a pair a point
    assert 0 <= bev.atomics_sent(cloud, height_res, *cfgs) \
        <= bev.atomics_sent(cloud, height_res, *cfgs, v1=True)
    return got


def _synthetic_batch(dev, b, p, span, seed):
    """``b`` clouds of ``p`` slots: uniform points in ±``span`` (some outside
    the grid), a third ground, ragged counts."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-span, span, (b, p, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(-4.0, 12.0, (b, p))
    label = (rng.random((b, p)) > 0.33).astype(np.int32)
    count = rng.integers(p // 2, p + 1, b)
    zeros = torch.zeros((b, p), device=dev)
    return Cloud(xyz=torch.from_numpy(xyz).to(dev), intensity=zeros, row=zeros.int(),
                 col=zeros.int(), t=zeros.long(), label=torch.from_numpy(label).to(dev),
                 count=torch.from_numpy(count).to(dev))


@pytest.mark.cuda
def test_bev_raster(dev, tmp_path):
    params, ordered = _labeled_batch(dev, tmp_path)
    labeled, _ = ground.mark_ground(ordered, params)
    got = _hold_rasters(labeled, params.height_res)
    assert int(got[0].count_nonzero()) > 0 and int(got[1].count_nonzero()) > 0
    one = Cloud(**{k: getattr(labeled, k)[1] for k in
                   ("xyz", "intensity", "row", "col", "t", "label")}, count=int(labeled.count[1]))
    alone = _hold_rasters(one, params.height_res)  # no batch axis
    assert torch.equal(alone[0], got[0][1]) and torch.equal(alone[1], got[1][1])

    # a 100² grid (rows 16-byte aligned), a 101² one (they are not), 1 and 24
    # layers; 1,000 slots a cloud (a ragged last block), 1,023 (rows of xyz not
    # 16-byte aligned)
    for max_range, p in ((50.0, 1000), (50.5, 1023), (50.0, 256)):
        for layers in (1, 24):
            cfgs = (MultiBevConfig(max_range=max_range, num_layers=layers),
                    SingleBevConfig(max_range=max_range))
            assert cfgs[0].mat_size in (100, 101)
            cloud = _synthetic_batch(dev, 3, p, 60.0, seed=p + layers)
            _hold_rasters(cloud, 0.5, *cfgs)
            # a cloud with no point, and one whose every point is ground
            empty = cloud.replace(count=torch.tensor([0, p, 5], device=dev))
            got = _hold_rasters(empty, 0.5, *cfgs)
            assert int(got[0][0].count_nonzero()) == 0 and int(got[1][0].count_nonzero()) == 0
            ground_only = cloud.replace(label=torch.zeros_like(cloud.label))
            assert int(_hold_rasters(ground_only, 0.5, *cfgs)[0].count_nonzero()) == 0
            # NaN and infinite coordinates, and points exactly on the grid's edges
            odd = cloud.xyz.clone()
            odd[0, :6, 0] = torch.tensor([float("nan"), float("inf"), -float("inf"), -max_range,
                                          max_range, max_range - 1.0], device=dev)
            odd[1, :4, 1] = torch.tensor([-max_range, max_range, -max_range - 0.5,
                                          max_range - 0.5], device=dev)
            odd[2, :3, 2] = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
            _hold_rasters(cloud.replace(xyz=odd, label=torch.ones_like(cloud.label)), 0.5, *cfgs)


@pytest.mark.cuda
def test_ground_sums(dev, tmp_path):
    params, ordered = _labeled_batch(dev, tmp_path)
    cfg = ground.GroundConfig()
    _, gm = ground.mark_ground(ordered, params)
    g = (gm.reshape(gm.shape[0], -1) == 1)
    srow, scol = ground._belonging_grid(ordered.xyz[..., 0], ordered.xyz[..., 1], cfg)
    values, seg, order = ground.sector_sums_rows(srow * cfg.grid_cols + scol,
                                                 ordered.xyz[..., 2], g, cfg)
    init = (0.0, cfg.count_epsilon)
    n_out = g.shape[0] * cfg.grid_rows * cfg.grid_cols
    assert int((seg < n_out).sum()) == int(g.sum()) > 0
    _hold_segment_sums(values, seg, init, n_out, order)
    rng = np.random.default_rng(8)
    for name, lengths, gaps in _segment_cases():
        values, seg, n_out = _segment_rows(lengths, gaps, 2, rng, dev)
        _hold_segment_sums(values, seg, init, n_out)
        # the same rows, scattered and read through an order
        perm = torch.from_numpy(rng.permutation(seg.shape[0])).to(dev)
        scattered = torch.empty_like(values)
        scattered[perm] = values
        _hold_segment_sums(scattered, seg, init, n_out, perm)


def _manip_cloud(seed: int, n: int, dev, nan: bool = False) -> Cloud:
    """Points over ±115 m with cell-edge coordinates and ground labels; with
    ``nan``, NaN heights on in-range non-ground points (one sign-set, three
    sharing a cell)."""
    from pctpu_torch.cloud import make_cloud

    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-115, 115, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-4.5, 6, n)
    xyz[: n // 5, :2] = rng.integers(-101, 101, (n // 5, 2)) - np.float32(0.5)
    label = np.where(rng.random(n) < 0.3, 0, 1).astype(np.int32)
    if nan:
        pick = np.flatnonzero((np.abs(xyz[:, :2]) < 90).all(1) & (label != 0))[:5]
        xyz[pick, 2] = np.nan
        xyz[pick[1], 2] = -np.float32(np.nan)
        xyz[pick[2:], :2] = xyz[pick[2], :2]
    return make_cloud(xyz, label=label, capacity=n + 64, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("filter_ground", [True, False])
def test_float_bev_card_equals_cpu(dev, nan, filter_ground):
    """The float BEV's scatter-max on the card, single and batched, equals
    the CPU's bit for bit (NaN heights included, one of them sign-set: a NaN
    keeps x86's bits, not the card's canonical NaN)."""
    from pctpu_torch.cloud import stack_clouds
    from pctpu_torch.config import FloatBevConfig

    cfg = FloatBevConfig(filter_ground=filter_ground)
    clouds = [_manip_cloud(s, 40000, dev, nan) for s in range(3)]
    got = bev.float_bev(stack_clouds(clouds), cfg)
    want = bev.float_bev(stack_clouds([c.replace(**{f: getattr(c, f).cpu() for f in (
        "xyz", "intensity", "row", "col", "t", "label")}) for c in clouds]), cfg)
    assert _bit_equal([got.cpu()], [want])
    assert _bit_equal([bev.float_bev(clouds[1], cfg).cpu()], [want[1]])
    assert bool(torch.isnan(want).any()) == nan


@pytest.mark.cuda
@pytest.mark.parametrize("yaw", [0.0, 30.0, -117.3, 359.99])
def test_transform_card_equals_cpu(dev, yaw):
    """cloud_manip's transform (each product and sum rounded in turn) on the
    card is bit-equal to the CPU's, NaN and infinite coordinates included
    (a NaN keeps x86's bits, not the card's canonical NaN)."""
    import math

    from pctpu_torch.ops.transform import make_rigid_transform, transform_cloud

    cloud = _manip_cloud(int(abs(yaw)) + 7, 100000, dev)
    xyz = cloud.xyz.clone()
    xyz[:4] = torch.tensor([[float("nan")] * 3, [float("inf"), 1.0, 2.0],
                            [-float("inf"), float("inf"), -float("nan")],
                            [3.0, -float("nan"), float("inf")]])
    cloud = cloud.replace(xyz=xyz)
    m = make_rigid_transform(1.5, -2.0, 0.25, yaw / 180.0 * math.pi)
    got = transform_cloud(cloud, m).xyz.cpu()
    want = transform_cloud(cloud.replace(xyz=cloud.xyz.cpu()), m).xyz
    assert _bit_equal([got], [want])


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["top", "front"])
def test_render_snapshot_card_equals_cpu(dev, view):
    """The snapshot's z-buffer on the card gives the CPU's image."""
    from pctpu_torch.ops.render import Layer, render_snapshot, segment_points

    rng = np.random.default_rng(3)
    a = rng.uniform(-40, 40, (50000, 3)).astype(np.float32)
    m = rng.random(50000) > 0.2
    layers = [Layer(a, (255, 0, 0), mask=m), Layer(a[::3] + 0.25, (0, 255, 0)),
              Layer(segment_points(a[:4], a[4:8]), (255, 255, 255))]
    got = render_snapshot(layers, view=view, device=dev)
    want = render_snapshot(layers, view=view, device="cpu")
    assert np.array_equal(got, want) and len(np.unique(got.reshape(-1, 3), axis=0)) >= 3


def _pca_rows(n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n, 3)) * rng.uniform(0.5, 40.0, 3)).astype(np.float32)
    xyz[:, 2] *= rng.random() < 0.5  # flattened clouds, as the CLI's filter gives them
    return torch.from_numpy(xyz).to(dev), torch.from_numpy(rng.random(n) < 0.7).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2, 31, 32, 33, 1025, 4095, 4096, 4097, 8192, 8193, 20000])
def test_pca_moments(dev, n):
    """The kernel equals its twin on the card in every bit at ragged sizes
    (tiles of 4,096 rows and chunks of 2,048 live rows, one row more or
    less, the tree's level edges),
    with the rows masked at random, all masked, all kept, and kept in runs
    of 1,000 (tiles and fill warps with no live row between live ones)."""
    from pctpu_torch.ops import pca

    xyz, mask = _pca_rows(n, n, dev)
    runs = (torch.arange(n, device=dev) // 1000) % 3 == 1
    for m in (mask, torch.zeros_like(mask), torch.ones_like(mask), runs):
        got = pca.pca_moments(xyz, m)
        assert _bit_equal(got, pca.pca_moments_reference(xyz, m)), n


@pytest.mark.cuda
def test_pca_moments_nan_and_inf(dev):
    """NaN and ±inf rows, masked and kept: the kernel's NaNs and infinities
    fall where the twin's do, bit for bit on the card."""
    from pctpu_torch.ops import pca

    xyz, mask = _pca_rows(3000, 5, dev)
    xyz[10, 0] = float("nan")
    xyz[20, 1] = float("inf")
    xyz[2500, 2] = -float("inf")
    xyz[2999] = float("nan")
    for m in (mask, torch.ones_like(mask), torch.zeros_like(mask)):
        got = pca.pca_moments(xyz, m)
        assert _bit_equal(got, pca.pca_moments_reference(xyz, m))
    mu, cov = pca.pca_moments(xyz[:100], mask[:100])
    assert bool(torch.isnan(mu[0])) and bool(torch.isnan(cov).any())


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [False, True])
def test_icp_bits_do_not_hang_on_the_batch_size(dev, plane):
    """A problem's ICP result on the card is the same in a batch of 16 and
    of 8 (the point-axis sums in f64): what lets a data mesh's shards
    report what the unsharded batch reports."""
    from pctpu_torch.config import RegistrationConfig
    from pctpu_torch.ops import icp, normals2d

    rng = np.random.default_rng(9)
    n = 8192
    x = torch.from_numpy(rng.uniform(-40, 40, (16, n, 3)).astype(np.float32)).to(dev)
    if plane:
        x[..., 2] = 0.0
    y = x + torch.from_numpy(rng.normal(0, 0.05, (16, n, 3)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.random((16, n)) > 0.1).to(dev)
    guess = torch.eye(4, device=dev).repeat(16, 1, 1)
    cfg = RegistrationConfig().coarse if plane else RegistrationConfig().fine
    kw = {}
    if plane:
        nrm, _, ok = normals2d.normals_2d(y, m, radius=1.0)
        kw = dict(tgt_normals=nrm, normal_mask=ok)

    def run(p):
        extra = {k: v[:p] for k, v in kw.items()}
        return icp.icp_batched(x[:p], m[:p], y[:p], m[:p], guess[:p], cfg, **extra)

    a, b = run(16), run(8)
    assert _bit_equal((a.transform[:8], a.fitness[:8]), (b.transform, b.fitness))


@pytest.mark.cuda
def test_sharded_nn_1_on_a_logical_mesh(dev):
    from pctpu_torch.ops.knn import nn_1
    from pctpu_torch.parallel.mesh import make_mesh, sharded_nn_1

    rng = np.random.default_rng(10)
    q, qm = _cloud(rng, 5000, dev)
    t, tm = _cloud(rng, 12288, dev)
    for points in (2, 4):
        got = sharded_nn_1(make_mesh(n_data=1, n_points=points, devices=[dev] * points))(
            q, qm, t, tm)
        want = nn_1(q, qm, t, tm)
        assert torch.equal(got[0], want[0]) and _bit_equal(got[1:], want[1:]), points


def nan_normal_scene():
    """pctpu's ``tests/test_pallas_knn.py:133`` scene, as numpy arrays
    (src, src mask, tgt, tgt mask, normals, normal mask, guess): two walls,
    one excluded target with a NaN normal parked far away, where the pruned
    path's idx-0 convention for unmatched queries can land, and masked
    source padding."""
    rng = np.random.default_rng(3)
    n = 80
    u = rng.uniform(-6, 6, n)
    wall = rng.integers(0, 2, n)
    x = np.where(wall == 0, u, -4.0 + rng.normal(0, 0.01, n))
    y = np.where(wall == 0, 4.0 + rng.normal(0, 0.01, n), u)
    tgt = np.stack([x, y, np.zeros(n)], 1).astype(np.float32)
    nrm = np.where(wall[:, None] == 0, np.array([[0.0, 1.0, 0.0]], np.float32),
                   np.array([[1.0, 0.0, 0.0]], np.float32)).astype(np.float32)
    ok = np.ones(n, bool)
    tgt[0] = [-100.0, -100.0, 0.0]
    nrm[0] = np.nan
    ok[0] = False
    src = (tgt[5:65] - np.float32([0.2, -0.1, 0.0])).astype(np.float32)
    sm = np.ones(60, bool)
    sm[55:] = False
    return src, sm, tgt, np.ones(n, bool), nrm, ok, np.eye(4, dtype=np.float32)


NAN_NORMAL_ICP = dict(max_correspondence_distance=2.0, max_iterations=6, point_to_plane=True)


def icp_nan_normal(device, nn_impl):
    """``icp_point_to_plane`` on :func:`nan_normal_scene` on ``device``."""
    from pctpu_torch.config import IcpConfig
    from pctpu_torch.ops.icp import icp_point_to_plane

    args = [torch.from_numpy(a).to(device) for a in nan_normal_scene()]
    return icp_point_to_plane(*args, IcpConfig(**NAN_NORMAL_ICP), nn_impl=nn_impl).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("nn_impl", ["pruned", "xla"])
def test_icp_pruned_nan_normal_not_poisoning(dev, nn_impl):
    """(tests/test_pallas_knn.py:133) A NaN normal on an excluded target and
    masked source padding do not poison the point-to-plane solve on the
    card, through the pruned kernel or the brute force: finite, and within
    1e-5 of the CPU brute force (held against pctpu by
    ``test_torch_nn_pruned.py``)."""
    got, want = icp_nan_normal(dev, nn_impl), icp_nan_normal("cpu", "xla")
    assert np.isfinite(got.transform).all() and np.isfinite(got.fitness)
    np.testing.assert_allclose(got.transform, want.transform, atol=1e-5)


@pytest.mark.cuda
def test_wire_pinned_round_trip(dev):
    """The BEV pipelines' wire on the card, a batch of 8 HDL-64E-sized
    clouds of random bits: the upload lands on the card in the on-disk
    widths, the copy back comes through pinned host tensors with every bit
    of every field, and one batch's arrays are unchanged after the next
    batch's copy back."""
    from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _upload, _wire

    rng = np.random.default_rng(11)
    b, c = 8, 133312

    def batch():
        return {"xyz": rng.integers(0, 2**32, (b, c, 3), np.uint32).view(np.float32),
                "intensity": rng.integers(0, 2**32, (b, c), np.uint32).view(np.float32),
                "row": rng.integers(0, 2**16, (b, c), np.uint16),
                "col": rng.integers(0, 2**16, (b, c), np.uint16),
                "t": rng.integers(0, 2**32, (b, c), np.uint32),
                "label": rng.integers(-2**15, 2**15, (b, c), np.int16),
                "count": np.full(b, c, np.int32)}

    first_in, second_in = batch(), batch()
    up = _upload(first_in, dev)
    assert {k: (x.device, x.dtype) for k, x in up.items()} == {
        "xyz": (dev, torch.float32), "intensity": (dev, torch.float32),
        "row": (dev, torch.int16), "col": (dev, torch.int16), "t": (dev, torch.int32),
        "label": (dev, torch.int16), "count": (dev, torch.int32)}
    first = _to_host([_wire(_to_device(first_in, dev))])
    kept = {k: a.copy() for k, a in first.items()}
    second = _to_host([_wire(_to_device(second_in, dev))])
    for k, a in first.items():
        assert torch.from_numpy(a).is_pinned(), k
        np.testing.assert_array_equal(a.view(np.uint8), first_in[k].view(np.uint8), err_msg=k)
        np.testing.assert_array_equal(a.view(np.uint8), kept[k].view(np.uint8), err_msg=k)
        np.testing.assert_array_equal(second[k].view(np.uint8), second_in[k].view(np.uint8),
                                      err_msg=k)


@pytest.mark.cuda
def test_ordering_counts_add_no_sync(dev):
    """On the card, a general-path batch through ``preprocess_batch``,
    ``_wire`` and ``_to_host`` raises as many of torch's sync warnings with
    the ordering's counts taken (tracing on) as without, and the counters
    hold the batch's in-bounds points and the slots lost to later points."""
    import warnings

    from pctpu_torch.ops.preprocess import preprocess_batch
    from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _wire
    from pctpu_torch.runtime import profiler

    params = SensorParams(n_scan=32, horizon_scan=1056, ground_upper_scan=20, height_res=0.5)
    rng = np.random.default_rng(23)
    b, c = 4, 34720
    arrays = {"xyz": rng.uniform(-60, 60, (b, c, 3)).astype(np.float32),
              "intensity": rng.uniform(0, 1, (b, c)).astype(np.float32),
              "row": rng.integers(0, 33, (b, c)).astype(np.uint16),
              "col": rng.integers(0, 1056, (b, c)).astype(np.uint16),
              "t": np.zeros((b, c), np.uint32), "label": np.full((b, c), -2, np.int16),
              "count": np.array([c, 30000, 20000, 5], np.int32)}
    points = lost = 0
    for k in range(b):
        n = int(arrays["count"][k])
        row, col = arrays["row"][k, :n].astype(np.int64), arrays["col"][k, :n].astype(np.int64)
        ok = row < 32
        points += int(ok.sum())
        lost += int(ok.sum()) - len(np.unique(row[ok] * 1056 + col[ok]))

    def syncs() -> tuple[int, dict]:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                labeled, multi, single = preprocess_batch(_to_device(arrays, dev), params)
                host = _to_host([{**_wire(labeled), "multi": multi, "single": single}])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in caught), host

    syncs()  # the kernels' first build and launch
    off, host_off = syncs()
    with profiler.recording() as rec:
        on, host_on = syncs()
    assert on == off
    assert rec.totals()["ordering.points"] == points
    assert rec.totals()["ordering.slots_lost"] == lost
    for k in host_off:
        np.testing.assert_array_equal(host_on[k].view(np.uint8), host_off[k].view(np.uint8))


@pytest.mark.cuda
def test_stack_batch_pinned(dev):
    """On the card ``stack_batch`` stacks each field into pinned memory,
    bit for bit ``np.stack``; the upload copies it from there, and a kept
    batch's arrays are unchanged after later batches reuse the allocator's
    blocks."""
    from pctpu_torch.pipelines.multi_bev import _upload
    from pctpu_torch.runtime.loader import stack_batch

    rng = np.random.default_rng(12)

    def payloads():
        return [{"xyz": rng.integers(0, 2**32, (33792, 3), np.uint32).view(np.float32),
                 "intensity": rng.integers(0, 2**32, 33792, np.uint32).view(np.float32),
                 "row": rng.integers(0, 2**16, 33792, np.uint16),
                 "col": rng.integers(0, 2**16, 33792, np.uint16),
                 "t": rng.integers(0, 2**32, 33792, np.uint32),
                 "label": rng.integers(-2**15, 2**15, 33792, np.int16),
                 "count": np.int32(33792 - k)} for k in range(4)]

    first_in = payloads()
    first = stack_batch(first_in)
    kept = {k: a.copy() for k, a in first.items()}
    for k, a in first.items():
        assert torch.from_numpy(a).is_pinned(), k
        want = np.stack([p[k] for p in first_in])
        assert a.dtype == want.dtype and a.tobytes() == want.tobytes(), k
    up = _upload(first, dev)
    for _ in range(3):
        later = stack_batch(payloads())
        _upload(later, dev)
        del later
    torch.cuda.synchronize()
    for k, a in first.items():
        np.testing.assert_array_equal(a.view(np.uint8), kept[k].view(np.uint8), err_msg=k)
        got = up[k].cpu().numpy().view(np.uint8)
        np.testing.assert_array_equal(got, kept[k].view(np.uint8), err_msg=k)


def _upload_inputs(rng, cap, n):
    """A ``to_numpy``-style dict of ``cap`` slots (every bit random in the
    first ``n``, ``t`` as uint32) and ``make_cloud``'s ``n``-point inputs."""
    bits = lambda *shape: rng.integers(0, 2**32, shape, np.uint32)  # noqa: E731
    d = {"xyz": bits(cap, 3).view(np.float32), "intensity": bits(cap).view(np.float32),
         "row": bits(cap).view(np.int32), "col": bits(cap).view(np.int32), "t": bits(cap),
         "label": bits(cap).view(np.int32), "count": n}
    for k in ("xyz", "intensity", "row", "col", "t", "label"):
        d[k][n:] = 0
    kw = {k: d[k][:n] for k in ("intensity", "row", "col", "t", "label")}
    return d, kw


def _cloud_bytes(c) -> dict:
    return {k: getattr(c, k).cpu().contiguous().view(torch.uint8).numpy().tobytes()
            for k in ("xyz", "intensity", "row", "col", "t", "label")}


@pytest.mark.cuda
@pytest.mark.parametrize("ctor", ["from_numpy", "make_cloud"])
def test_staged_upload_matches_the_pageable_path(dev, monkeypatch, ctor):
    """On the card a Cloud crosses as one staged block: every field bit
    for bit what the six pageable copies gave, each a 256-byte-aligned
    contiguous view, the tail zero."""
    from pctpu_torch import cloud

    d, kw = _upload_inputs(np.random.default_rng(24), 139264, 130000)

    def build():
        if ctor == "from_numpy":
            return cloud.from_numpy(d, device=dev)
        return cloud.make_cloud(d["xyz"][:130000], capacity=139264, device=dev, **kw)

    staged = build()
    monkeypatch.setattr(cloud, "_staged", lambda device: False)
    pageable = build()
    torch.cuda.synchronize()
    assert _cloud_bytes(staged) == _cloud_bytes(pageable)
    base = staged.xyz.untyped_storage().data_ptr()
    for k in ("xyz", "intensity", "row", "col", "t", "label"):
        v, w = getattr(staged, k), getattr(pageable, k)
        assert v.device == dev and v.dtype == w.dtype and v.shape == w.shape, k
        assert v.is_contiguous() and v.data_ptr() % 256 == 0, k
        assert v.untyped_storage().data_ptr() == base, k
        assert not v[130000:].any(), k


@pytest.mark.cuda
@pytest.mark.parametrize("own_stream", [False, True])
def test_staged_upload_blocks_outlive_their_copies(dev, own_stream):
    """Two threads upload 200 distinct clouds each, back to back, on the
    default stream or a stream of their own held up behind a long kernel,
    so that every copy is still queued when later clouds are filled: each
    Cloud holds its own bytes, so no pinned block was handed out again
    before its copy had run, and the copies ran on the caller's stream."""
    import threading

    from pctpu_torch import cloud

    cap = 16384
    out: dict[int, list] = {0: [], 1: []}
    streams = {k: torch.cuda.Stream(dev) if own_stream else torch.cuda.default_stream(dev)
               for k in out}

    def upload(thread):
        with torch.cuda.stream(streams[thread]):
            torch.cuda._sleep(int(1e9))  # about 0.5 s of the card's clock
            for i in range(200):
                v = thread * 1000 + i
                d = {"xyz": np.full((cap, 3), v, np.float32),
                     "intensity": np.full(cap, v, np.float32), "row": np.full(cap, v, np.int32),
                     "col": np.full(cap, -v, np.int32), "t": np.full(cap, v, np.uint32),
                     "label": np.full(cap, v, np.int32), "count": cap}
                out[thread].append(cloud.from_numpy(d, device=dev))

    threads = [threading.Thread(target=upload, args=(k,)) for k in out]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    for thread, clouds in out.items():
        for i, c in enumerate(clouds):
            v = thread * 1000 + i
            for k, want in (("xyz", v), ("intensity", v), ("row", v), ("col", -v), ("t", v),
                            ("label", v)):
                assert bool((getattr(c, k) == want).all()), (thread, i, k)


@pytest.mark.cuda
def test_staged_upload_syncs_nothing_and_is_traced(dev):
    """Under torch's sync debug mode set to raise, both constructors
    upload without a host wait; traced, each counts
    ``cloud.upload.staged`` with its fill span, ``from_numpy`` inside
    ``cloud.upload``."""
    from pctpu_torch import cloud
    from pctpu_torch.runtime import profiler

    d, kw = _upload_inputs(np.random.default_rng(25), 8192, 8000)
    cloud.from_numpy(d, device=dev)  # the allocator's first blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiler.recording() as rec:
            a = cloud.from_numpy(d, device=dev)
            b = cloud.make_cloud(d["xyz"][:8000], capacity=8192, device=dev, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _cloud_bytes(a) == _cloud_bytes(b)
    assert rec.totals() == {"cloud.upload.staged": 2}
    (up,) = rec.named("cloud.upload")
    fills = rec.named("cloud.upload.fill")
    assert len(fills) == 2 and fills[0].parent == up.id

