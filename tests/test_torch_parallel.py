"""The port's parallel layer (pctpu_torch.parallel) and what it drives, on the
CPU, against pctpu on the same numpy inputs: the strided work split, the
process group's seam, meshes of logical CPU devices (``[cpu] * k``, the
counterpart of the conftest's 8 virtual XLA devices), the sharded
preprocess and 1-NN, the metric sum, the BEV and registration pipelines on
a data mesh and in emulated processes, the point-sharded fine stage,
``profiler.trace`` and the three CLIs' flags.  The cases mirror
tests/test_distributed.py and tests/test_sharding.py."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import pctpu.io.pcd as jpcd
import pctpu.pipelines.registration as jreg
from pctpu.cloud import make_cloud as jmake_cloud
from pctpu.config import GroundConfig as JGroundConfig
from pctpu.config import MultiBevConfig as JMultiBevConfig
from pctpu.config import RegistrationConfig as JRegistrationConfig
from pctpu.config import SensorParams as JSensorParams
from pctpu.config import SingleBevConfig as JSingleBevConfig
from pctpu.config import WHOLE_ICP as J_WHOLE_ICP
from pctpu.ops.knn import nn_1 as jnn_1
from pctpu.ops.preprocess import preprocess_batch as jpreprocess_batch
from pctpu.parallel import distributed as jdist
from pctpu.parallel import mesh as jmesh
from pctpu.pipelines.multi_bev import run_multi_bev as jrun_multi_bev
from pctpu_torch import cloud as tcloud
from pctpu_torch.cli import batch_multi_bev_gen as bev_cli
from pctpu_torch.cli import batch_top_part_registration as top_cli
from pctpu_torch.cli import batch_whole_registration as whole_cli
from pctpu_torch.config import WHOLE_ICP, RegistrationConfig, SensorParams
from pctpu_torch.io import pcd as tpcd
from pctpu_torch.ops.knn import nn_1
from pctpu_torch.ops.preprocess import preprocess_batch
from pctpu_torch.parallel import distributed, mesh
from pctpu_torch.pipelines import registration as reg
from pctpu_torch.pipelines.multi_bev import run_multi_bev
from pctpu_torch.runtime.profiler import trace

from .test_torch_registration_batched import CFG, WHOLE, _clouds, tree  # noqa: F401
from .test_torch_registration_e2e import SMALL as JSMALL

CPU = torch.device("cpu")
SMALL = (8, 64, 6, 0.5)  # n_scan, horizon_scan, ground_upper_scan, height_res


def cpu_mesh(n_data, n_points=1):
    return mesh.make_mesh(n_data=n_data, n_points=n_points, devices=[CPU] * (n_data * n_points))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these pipelines run beside other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- parallel.distributed ---------------------------------------------------

def test_process_shard_strided_partition():
    items = list(range(11))
    shards = [distributed.process_shard(items, pid, 3) for pid in range(3)]
    assert shards == [jdist.process_shard(items, pid, 3) for pid in range(3)]
    assert shards == [[0, 3, 6, 9], [1, 4, 7, 10], [2, 5, 8]]
    assert sorted(sum(shards, [])) == items
    assert distributed.process_shard(items, 0, 1) == items
    # no group: this process is 0 of 1, so the default shard is everything
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.process_shard(items) == items


def test_initialize_forwards_to_init_process_group(monkeypatch):
    """One process: no group.  Several: the coordinator and identity go to
    ``torch.distributed.init_process_group`` on gloo; without a coordinator,
    to torchrun's environment (a recording stub, as pctpu's test pins its
    seam)."""
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda **kwargs: calls.append(kwargs))
    distributed.initialize(num_processes=1, process_id=0)
    assert calls == []
    distributed.initialize("10.0.0.1:1234", num_processes=2, process_id=1)
    assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:1234",
                          world_size=2, rank=1)]
    distributed.initialize()
    assert calls[-1] == dict(backend="gloo", init_method="env://", world_size=-1, rank=-1)
    distributed.shutdown()  # no group joined: nothing to leave
    distributed.barrier()


def test_mesh_shapes(monkeypatch):
    m = mesh.make_mesh(n_points=2, devices=[CPU] * 8)
    assert m.shape == dict(jmesh.make_mesh(n_points=2).shape) == {"data": 4, "points": 2}
    assert m.data_devices == [CPU] * 4 and m.point_devices == [CPU] * 2
    assert cpu_mesh(8).shape == {"data": 8, "points": 1}
    # the default is every CUDA card the process sees, on the data axis
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.make_mesh().data_devices == [torch.device("cuda", i) for i in range(3)]
    assert distributed.global_mesh().shape == {"data": 3, "points": 1}
    assert distributed.global_mesh(n_points=3).shape == {"data": 1, "points": 3}
    with pytest.raises(ValueError, match="needs 4 devices, 3 CUDA cards visible"):
        mesh.make_mesh(n_data=4)
    with pytest.raises(ValueError, match="needs 4 devices, 2 given"):
        mesh.make_mesh(n_data=2, n_points=2, devices=[CPU] * 2)


@pytest.mark.parametrize("local_rank, n, cards", [
    (0, 1, [0]), (1, 1, [1]), (3, 1, [3]), (4, 1, [0]),  # one card a process
    (0, 2, [0, 1]), (1, 2, [2, 3]), (2, 2, [0, 1]),      # two cards a process
    (1, 3, [3, 0, 1]),                                   # blocks wrap
])
def test_process_cards_under_a_fake_card_count(monkeypatch, local_rank, n, cards):
    """Four faked cards: local rank r takes the n cards from r * n on,
    modulo four; torchrun's LOCAL_RANK wins over the process id."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    want = [torch.device("cuda", c) for c in cards]
    assert distributed.process_cards(n, local_rank) == want
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    assert distributed.process_cards(n, 7) == want
    with pytest.raises(ValueError, match="5 cards a process, this process sees 4"):
        distributed.process_cards(5, 0)


def test_one_card_processes_share_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert [distributed.process_cards(1, k) for k in range(3)] == [[torch.device("cuda", 0)]] * 3


def test_default_mesh_starts_at_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert mesh.make_mesh(n_data=2).data_devices == [torch.device("cuda", 2),
                                                     torch.device("cuda", 3)]
    assert mesh.make_mesh().data_devices == [torch.device("cuda", c) for c in (2, 3, 0, 1)]


@pytest.mark.parametrize("cli", [bev_cli, top_cli, whole_cli], ids=["bev", "top", "whole"])
@pytest.mark.parametrize("pid, devices, card", [(0, None, 0), (1, None, 1), (1, 2, 2)])
def test_cli_processes_take_cards_of_their_own(monkeypatch, capsys, cli, pid, devices, card):
    """On four faked cards each CLI process makes the first of its cards
    current before the pipeline runs; one process keeps the card it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "fake card")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    current = []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    runs = []
    for name in ("run_multi_bev", "run_batch_top_part_registration",
                 "run_batch_whole_registration"):
        if hasattr(cli, name):
            monkeypatch.setattr(cli, name, lambda *a, **kw: runs.append((list(current), kw)))
    extra = [] if devices is None else [f"--devices={devices}"]
    assert cli.main(["a", "b", "--num-processes=2", f"--process-id={pid}", *extra]) == 0
    assert current == [torch.device("cuda", card)]
    assert runs == [([torch.device("cuda", card)], runs[0][1])]
    assert f"process {pid} on cuda:{card}" in capsys.readouterr().out
    current.clear()
    assert cli.main(["a", "b", *extra]) == 0
    assert current == []


# --- parallel.mesh: preprocess, 1-NN, metrics ---------------------------------

def test_sharded_preprocess_matches_single_device():
    import __graft_entry__ as ge

    jparams = JSensorParams(*SMALL)
    jclouds = ge._example_cloud(batch=8, params=jparams, n_points=256)
    dtypes = dict(xyz=np.float32, intensity=np.float32, row=np.int32, col=np.int32,
                  t=np.int64, label=np.int32, count=np.int64)
    clouds = tcloud.Cloud(**{f: torch.from_numpy(np.asarray(getattr(jclouds, f)).astype(d))
                             for f, d in dtypes.items()})
    params = SensorParams(*SMALL)
    ref = preprocess_batch(clouds, params)
    m = cpu_mesh(4, 2)
    shards = mesh.shard_cloud_batch(clouds, m)
    assert [s.xyz.shape[0] for s in shards] == [2] * 4
    out = mesh.sharded_preprocess(m, params)(shards)
    for got, want in ((out[1], ref[1]), (out[2], ref[2]), (out[0].label, ref[0].label),
                      (out[0].xyz, ref[0].xyz)):
        assert torch.equal(got, want)
    jm = jmesh.make_mesh(n_data=4, n_points=2)
    jout = jmesh.sharded_preprocess(jm, jparams, JGroundConfig(), JMultiBevConfig(),
                                    JSingleBevConfig())(jmesh.shard_cloud_batch(jclouds, jm))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(out[0].label.numpy(), np.asarray(jout[0].label))
    np.testing.assert_array_equal(jpreprocess_batch(jclouds, jparams)[1], ref[1].numpy())
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_cloud_batch(clouds, cpu_mesh(3))


def test_data_slices_split_in_contiguous_blocks():
    """The one rule the pipelines split a batch by: contiguous blocks of
    n / data, in device order (pctpu's 'data' sharding of a leading axis)."""
    m = mesh.make_mesh(n_data=3, n_points=2, devices=[CPU] * 6)
    assert mesh.data_slices(12, m, "n") == [(slice(0, 4), CPU), (slice(4, 8), CPU),
                                            (slice(8, 12), CPU)]
    with pytest.raises(ValueError, match="n=10 must be a multiple of the mesh data axis"):
        mesh.data_slices(10, m, "n")


def _nn_inputs(seed, nq=64, nt=128, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, 3)).astype(np.float32)
    t = rng.standard_normal((nt, 3)).astype(np.float32)
    qm, tm = np.ones(nq, bool), np.ones(nt, bool)
    if masked:
        qm = rng.random(nq) > 0.1
        tm = rng.random(nt) > 0.1
        # an exact tie across the shards: one point in shard 0 and shard 3
        t[nt - 5] = t[3]
        q[7] = t[3] + np.float32(0.25)
        qm[7] = tm[3] = tm[nt - 5] = True
    return q, qm, t, tm


def test_sharded_nn_matches_pctpu():
    """pctpu's own case (tests/test_sharding.py): 4 x 2 mesh, tile 32."""
    q, qm, t, tm = _nn_inputs(0, masked=False)
    idx, d2 = mesh.sharded_nn_1(cpu_mesh(4, 2), tile=32)(
        *(torch.from_numpy(a) for a in (q, qm, t, tm)))
    j_idx, j_d2 = jmesh.sharded_nn_1(jmesh.make_mesh(n_data=4, n_points=2), tile=32)(q, qm, t, tm)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(j_d2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jnn_1(q, qm, t, tm, tile=32)[0]))


@pytest.mark.parametrize("seed,points", [(0, 2), (1, 4), (2, 8)])
def test_sharded_nn_bit_equal_to_nn_1(seed, points):
    """Masked points, an exact tie across shards, and near-equal winners in
    two shards (seed 0 has one): the winners and distances of ``nn_1`` over
    the whole target."""
    tq, tqm, tt, ttm = (torch.from_numpy(a) for a in _nn_inputs(seed))
    idx_ref, d2_ref = nn_1(tq, tqm, tt, ttm, tile=32)
    idx, d2 = mesh.sharded_nn_1(cpu_mesh(8 // points, points), tile=32)(tq, tqm, tt, ttm)
    np.testing.assert_array_equal(idx.numpy(), idx_ref.numpy())
    np.testing.assert_array_equal(d2.numpy().view(np.uint32), d2_ref.numpy().view(np.uint32))
    assert int(idx[7]) == 3  # the lowest shard wins the tie, as one device's argmin
    with pytest.raises(ValueError, match="must divide the target"):
        mesh.sharded_nn_1(cpu_mesh(1, 3))(tq, tqm, tt, ttm)


def test_psum_metrics():
    x = np.arange(8, dtype=np.float32)
    for n_data, n_points in ((8, 1), (4, 2)):
        total = mesh.psum_metrics(cpu_mesh(n_data, n_points))(x)
        want = jmesh.psum_metrics(jmesh.make_mesh(n_data=n_data, n_points=n_points))(x)
        assert float(total) == float(np.asarray(want)) == 28.0


# --- the BEV pipeline on a mesh and in emulated processes --------------------

def _bev_tree(root, n_clouds, rng):
    """pctpu's tests/test_distributed.py tree: random clouds, 25 m apart."""
    from pctpu.config import SensorParams as P

    params = P(*SMALL)
    cloud_dir = os.path.join(root, "keyframe_point_cloud")
    os.makedirs(cloud_dir)
    for i in range(n_clouds):
        n = 150
        xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        xyz[:, 2] = rng.uniform(-2.2, 3.0, n).astype(np.float32)
        c = jmake_cloud(xyz, intensity=rng.random(n).astype(np.float32),
                        row=rng.integers(0, params.n_scan, n).astype(np.int32),
                        col=rng.integers(0, params.horizon_scan, n).astype(np.int32),
                        label=np.full(n, -2, np.int32))
        jpcd.save_cloud_pcd(os.path.join(cloud_dir, f"{i:06d}.pcd"), c)
    with open(os.path.join(root, "keyframe_pose.csv"), "w") as f:
        for i in range(n_clouds):
            f.write(f"{i:06d},{i * 25.0:.6f},0.000000,0.000000,0,0,0,1.000000,0.000000,"
                    "0.000000,0.000000,1.000000,0.000000,0.000000,0.000000,1.000000\n")


BEV_OUT = ("output_multi_bev/binary", "output_single_bev/csv", "non_ground_point_cloud")


def _same_trees(a, b, n_clouds):
    for sub in BEV_OUT:
        names = sorted(os.listdir(os.path.join(a, sub)))
        assert names == sorted(os.listdir(os.path.join(b, sub))) and len(names) == n_clouds
        for name in names:
            with open(os.path.join(a, sub, name), "rb") as fa, \
                    open(os.path.join(b, sub, name), "rb") as fb:
                assert fa.read() == fb.read(), f"{sub}/{name} differs"
    with open(os.path.join(a, "keyframe_label.csv"), "rb") as fa, \
            open(os.path.join(b, "keyframe_label.csv"), "rb") as fb:
        assert fa.read() == fb.read()


def test_run_multi_bev_mesh_byte_identical(tmp_path):
    """A (4, 1) mesh and ``devices=4`` (batch 3 rounded up to 4): trees
    byte-identical to the port's unsharded run and to pctpu's."""
    roots = [str(tmp_path / k) for k in ("pctpu", "single", "meshed", "devices")]
    _bev_tree(roots[0], 5, np.random.default_rng(3))  # odd: a padded batch
    for r in roots[1:]:
        shutil.copytree(roots[0], r)
    jrun_multi_bev(roots[0], JSensorParams(*SMALL), batch_size=4, write_pngs=False)
    params = SensorParams(*SMALL)
    run_multi_bev(roots[1], params, batch_size=4, write_pngs=False, device="cpu")
    run_multi_bev(roots[2], params, batch_size=4, write_pngs=False, mesh=cpu_mesh(4),
                  device="cpu")
    out = run_multi_bev(roots[3], params, batch_size=3, write_pngs=False, devices=4,
                        device="cpu")
    assert out.num_clouds == 5
    for r in roots[1:]:
        _same_trees(roots[0], r, 5)


def test_run_multi_bev_two_process_emulation(tmp_path):
    """Process 0 then process 1 on one tree: strided 3 + 2 clouds, labels
    by process 0 only, the merged tree the one-process tree; process 1
    keeps process 0's outputs without ``resume``."""
    single, multi = str(tmp_path / "single"), str(tmp_path / "multi")
    _bev_tree(single, 5, np.random.default_rng(5))
    shutil.copytree(single, multi)
    params = SensorParams(*SMALL)
    run_multi_bev(single, params, batch_size=4, write_pngs=False, device="cpu")
    out0 = run_multi_bev(multi, params, batch_size=4, write_pngs=False, process_id=0,
                         num_processes=2, device="cpu")
    marker = os.path.join(multi, "output_multi_bev/binary/000000.bin")
    assert os.path.exists(marker)
    out1 = run_multi_bev(multi, params, batch_size=4, write_pngs=False, process_id=1,
                         num_processes=2, device="cpu")
    assert os.path.exists(marker)
    assert (out0.num_clouds, out1.num_clouds) == (3, 2)
    assert out0.num_major_frames > 0 and out1.num_major_frames == 0
    _same_trees(single, multi, 5)


# --- registration: data mesh, processes, point mesh -------------------------

# (query, match, yaw guess) by cloud index in the batched tests' tree
MESH_PAIRS = [(0, 1, 9.0), (1, 0, -9.0), (2, 1, -165.0), (0, 2, 174.0)]
WHOLE_DEFAULT, J_WHOLE_DEFAULT = (RegistrationConfig(fine=WHOLE_ICP),
                                  JRegistrationConfig(fine=J_WHOLE_ICP))


def _pairs(tree, idx_pairs):
    """The same pairs for the port and for pctpu, from the tree's PCDs."""
    _, _, clouds = tree
    port = _clouds(tree)
    ref = [jpcd.load_cloud_pcd(f"{clouds}/{k:06d}.pcd", 1024) for k in range(len(port))]
    return ([(port[q], port[m], g) for q, m, g in idx_pairs],
            [(ref[q], ref[m], g) for q, m, g in idx_pairs])


def _same_icp(a, b):
    np.testing.assert_array_equal(a.transform, b.transform)
    assert float(a.fitness) == float(b.fitness) and bool(a.converged) == bool(b.converged)


def _near_pctpu(got, ref):
    np.testing.assert_allclose(got.transform, np.asarray(ref.transform), atol=1e-4)
    assert abs(float(got.fitness) - float(ref.fitness)) <= 1e-4 * float(ref.fitness)


def test_register_pairs_mesh_matches_unsharded_and_pctpu(tree):  # noqa: F811
    pairs, jpairs = _pairs(tree, MESH_PAIRS)
    plain = reg.register_pairs(pairs, CFG, flat_cap=1024)
    meshed = reg.register_pairs(pairs, CFG, flat_cap=1024, mesh=cpu_mesh(2))
    ref = jreg.register_pairs(jpairs, JSMALL, flat_cap=1024,
                              mesh=jmesh.make_mesh(n_data=2, n_points=1))
    for (b0, f0), (b1, f1), (rb, rf) in zip(plain, meshed, ref):
        _same_icp(b0, b1)
        _same_icp(f0, f1)
        _near_pctpu(f1, rf)
    with pytest.raises(ValueError, match="multiple of the mesh data axis"):
        reg.register_pairs(pairs[:3], CFG, flat_cap=1024, mesh=cpu_mesh(2))


def test_register_whole_pairs_mesh_matches_unsharded_and_pctpu(tree):  # noqa: F811
    pairs, jpairs = _pairs(tree, MESH_PAIRS)
    plain = reg.register_whole_pairs(pairs, WHOLE_DEFAULT)
    meshed = reg.register_whole_pairs(pairs, WHOLE_DEFAULT, mesh=cpu_mesh(4))
    ref = jreg.register_whole_pairs(jpairs, J_WHOLE_DEFAULT,
                                    mesh=jmesh.make_mesh(n_data=4, n_points=1))
    for a, m, r in zip(plain, meshed, ref):
        _same_icp(a, m)
        _near_pctpu(m, r)


def test_register_pair_point_sharded_fine(tree):  # noqa: F811
    """The fine stage's search over a 'points' axis of 4: bit-equal to the
    unsharded CPU run (both are ``nn_1``'s winners) and within the window
    of pctpu's point-sharded run."""
    [(c0, c1, _)], [(j0, j1, _)] = _pairs(tree, MESH_PAIRS[:1])
    b0, f0 = reg.register_pair(c0, c1, 9.0, CFG, flat_cap=1024)
    b1, f1 = reg.register_pair(c0, c1, 9.0, CFG, flat_cap=1024, point_mesh=cpu_mesh(1, 4))
    _same_icp(b0, b1)
    _same_icp(f0, f1)
    _, jf = jreg.register_pair(j0, j1, 9.0, JSMALL, flat_cap=1024,
                               point_mesh=jmesh.make_mesh(n_data=2, n_points=4))
    _near_pctpu(f1, jf)
    with pytest.raises(ValueError, match="multiple of the 'points' axis"):
        reg.register_pair(c0, c1, 9.0, CFG, flat_cap=1024, point_mesh=cpu_mesh(1, 3))


def test_icp_sharded_needs_a_mesh():
    from pctpu_torch.ops import icp

    x = torch.zeros((8, 3))
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs a mesh"):
        icp.icp(x, m, x, m, torch.eye(4), CFG.fine, nn_impl="sharded")


def test_prepare_batch_driver_shards_and_rounds(tree):  # noqa: F811
    _, match, clouds = tree
    matches, report, mode, cap, pair_batch, m = reg._prepare_batch_driver(
        match, clouds, "rep.txt", None, 4, 3, 1, 2, False, "cpu")
    full = reg.load_match_results(match)
    assert matches == full[1::2] and report == "rep.txt.shard1" and mode == "w"
    assert cap == 8192 and pair_batch == 6
    assert m.shape == {"data": 3, "points": 1} and m.data_devices == [CPU] * 3
    one = reg._prepare_batch_driver(match, clouds, "rep.txt", 1024, None, None, None, None,
                                    False, "cpu")
    assert one[0] == full and one[1] == "rep.txt" and one[4] == 1 and one[5] is None


def test_batch_registration_process_shards_merge(tree, tmp_path):  # noqa: F811
    """Two emulated processes at --pair-batch=2 on a 2-device mesh: the
    ``.shard<k>`` reports, interleaved back in strided order, are the
    one-process report; the whole-cloud counts add up."""
    _, match, clouds = tree
    kw = dict(cfg=CFG, capacity=1024, flat_cap=1024, pair_batch=2, device="cpu")
    seq = reg.run_batch_top_part_registration(match, clouds, report_path=str(tmp_path / "one.txt"),
                                              **kw)
    shards = [reg.run_batch_top_part_registration(
        match, clouds, report_path=str(tmp_path / "rep.txt"), devices=2, process_id=pid,
        num_processes=2, **kw) for pid in (0, 1)]
    assert [len(s) for s in shards] == [2, 1]
    merged = [r for pair in zip(shards[0], shards[1] + [None]) for r in pair if r is not None]
    for a, b in zip(seq, merged):
        assert (a.query_idx, a.match_idx, a.success) == (b.query_idx, b.match_idx, b.success)
        np.testing.assert_array_equal(a.transform_fine, b.transform_fine)
    lines = [iter(open(tmp_path / f"rep.txt.shard{k}").read().splitlines()) for k in (0, 1)]
    interleaved = [next(lines[k % 2]) for k, r in enumerate(merged) if r.success]
    assert interleaved == open(tmp_path / "one.txt").read().splitlines()
    one = reg.run_batch_whole_registration(match, clouds, cfg=WHOLE, capacity=1024, pair_batch=2,
                                           report_path=str(tmp_path / "w1.txt"), device="cpu")
    counts = [reg.run_batch_whole_registration(
        match, clouds, cfg=WHOLE, report_path=str(tmp_path / "w.txt"), capacity=1024,
        pair_batch=2, devices=2, process_id=pid, num_processes=2, device="cpu")
        for pid in (0, 1)]
    assert sum(counts[0]) == 2 and sum(counts[1]) == 1
    assert (counts[0][0] + counts[1][0], counts[0][1] + counts[1][1]) == one
    assert os.path.exists(tmp_path / "w.txt.shard0") and os.path.exists(tmp_path / "w.txt.shard1")


# --- profiler.trace and the CLIs' flags --------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    with trace("quiet", enabled=False, trace_dir=str(tmp_path / "off")):
        torch.ones(3).sum()
    assert not (tmp_path / "off").exists()
    with trace("pctpu_span", enabled=True, trace_dir=str(tmp_path / "on")):
        torch.ones(64).cumsum(0)
    (path,) = (tmp_path / "on").iterdir()
    assert path.name == f"pctpu_span.{os.getpid()}.pt.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "pctpu_span" for e in events)


def test_bev_cli_takes_every_pctpu_flag(tmp_path, capsys):
    """--devices, --num-processes, --process-id, --coordinator (ignored for
    one process, as pctpu ignores it) and --profile, on the CPU."""
    from pctpu_torch.experiments.scene import multi_bev_tree
    from pctpu_torch.config import get_sensor_params

    root = str(tmp_path / "tree")
    multi_bev_tree(root, get_sensor_params("HDL_32E"), n_ordered=3, n_raw=0, n_over=0)
    prof = tmp_path / "prof"
    argv = [root, "HDL_32E", "--device=cpu", "--devices=2", "--batch-size=1", "--no-pngs",
            "--num-processes=2", "--process-id=1", f"--profile={prof}"]
    assert bev_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "batch_size rounded up to 2 for 2-way mesh" in out and "One-hot" not in out
    assert sorted(os.listdir(os.path.join(root, "non_ground_point_cloud"))) == ["000001.pcd"]
    (path,) = prof.iterdir()
    assert "batch_multi_bev_gen" in path.read_text()
    assert bev_cli.main([root, "HDL_32E", "--device=cpu", "--coordinator=127.0.0.1:9",
                         "--num-processes=1", "--no-pngs"]) == 0
    assert len(os.listdir(os.path.join(root, "non_ground_point_cloud"))) == 3


@pytest.mark.parametrize("kind", ["top", "whole"])
def test_registration_clis_take_every_pctpu_flag(tree, tmp_path, monkeypatch, kind):  # noqa: F811
    """--devices, --num-processes, --process-id and --coordinator: the CLI
    joins the group (a recording stub in place of a real coordinator), runs
    its strided share on a 2-device mesh into ``<report>.shard0`` and
    leaves the group."""
    _, match, clouds = tree
    cli, run = ((top_cli, "run_batch_top_part_registration") if kind == "top"
                else (whole_cli, "run_batch_whole_registration"))
    real = getattr(reg, run)
    seen = {}

    def runner(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, cfg=CFG if kind == "top" else WHOLE, **kwargs)

    group = []
    monkeypatch.setattr(cli, run, runner)
    monkeypatch.setattr(distributed, "initialize", lambda *a: group.append(("join",) + a))
    monkeypatch.setattr(distributed, "shutdown", lambda: group.append(("leave",)))
    report = str(tmp_path / "r.txt")
    argv = [match, clouds, f"--report={report}", "--capacity=1024", "--device=cpu",
            "--pair-batch=1", "--devices=2", "--num-processes=2", "--process-id=0",
            "--coordinator=127.0.0.1:29500"]
    assert cli.main(argv + (["--flat-cap=1024"] if kind == "top" else [])) == 0
    assert group == [("join", "127.0.0.1:29500", 2, 0), ("leave",)]
    assert (seen["devices"], seen["num_processes"], seen["process_id"]) == (2, 2, 0)
    assert open(report + ".shard0.progress").read().splitlines() == ["0 1", "2 1"]
