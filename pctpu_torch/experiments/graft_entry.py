"""The driver's entry points — the port of ``__graft_entry__.py``.

``entry(device)`` returns the flagship step, the fused ordering + ground
marking + multi/single BEV of a batch (``ops.preprocess.preprocess_batch``,
the hot loop of batch_multi_bev_gen), with an HDL-64E example cloud on
``device``.

``dryrun_multichip(n, devices)`` runs each parallel entry of the port once
on a (data × points) mesh of ``devices`` (``parallel.mesh.make_mesh``; a
device may repeat, so ``[cuda:0] * n`` is a logical mesh on one card and
``[cpu] * n`` one on the CPU), at tiny shapes, with pctpu's assertions: the
sharded preprocess over ``data``, the 1-NN with its target over
``points``, ``psum_metrics``, ``run_multi_bev(mesh=)``,
``register_pairs(mesh=)`` and ``run_batch_whole_registration(mesh=)``.
"""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np
import torch


def _example_cloud(batch: int, params, n_points: int, seed: int = 0, device="cuda"):
    """The port's copy of ``__graft_entry__._example_cloud``: the same values
    from the same seed, as a batched Cloud on ``device``."""
    from pctpu_torch.cloud import Cloud

    rng = np.random.default_rng(seed)
    g = params.grid_size
    xyz = rng.uniform(-80, 80, (batch, g, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(-2.5, 6.0, (batch, g)).astype(np.float32)
    row = rng.integers(0, params.n_scan, (batch, g)).astype(np.int32)
    col = rng.integers(0, params.horizon_scan, (batch, g)).astype(np.int32)
    mask = np.broadcast_to(np.arange(g)[None, :] < n_points, (batch, g))
    intensity = rng.random((batch, g)).astype(np.float32) * mask

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return Cloud(xyz=t(xyz * mask[..., None], torch.float32),
                 intensity=t(intensity, torch.float32),
                 row=t(row * mask, torch.int32), col=t(col * mask, torch.int32),
                 t=torch.zeros((batch, g), dtype=torch.int64, device=device),
                 label=t(np.where(mask, -2, 0), torch.int32),
                 count=torch.full((batch,), n_points, dtype=torch.int64, device=device))


def entry(device="cuda"):
    """(fn, example_args): the flagship step on one device."""
    from pctpu_torch.config import (GroundConfig, MultiBevConfig, SingleBevConfig,
                                    get_sensor_params)
    from pctpu_torch.ops.preprocess import preprocess_batch

    params = get_sensor_params("HDL_64E")
    fn = functools.partial(preprocess_batch, params=params, ground_cfg=GroundConfig(),
                           multi_cfg=MultiBevConfig(), single_cfg=SingleBevConfig())
    example = _example_cloud(batch=1, params=params, n_points=100_000, device=device)
    return fn, (example,)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One run of each parallel entry on an ``n_devices`` mesh of
    ``devices`` (default: the CUDA cards this process sees), tiny shapes;
    raises on a failed assertion (``__graft_entry__.py:60-243``)."""
    from pctpu_torch.cloud import make_cloud
    from pctpu_torch.config import (GroundConfig, IcpConfig, MultiBevConfig,
                                    RegistrationConfig, SensorParams, SingleBevConfig)
    from pctpu_torch.experiments.bench import BUILD_DIR
    from pctpu_torch.io.pcd import save_cloud_pcd
    from pctpu_torch.parallel.mesh import (make_mesh, psum_metrics, shard_cloud_batch,
                                           sharded_nn_1, sharded_preprocess)
    from pctpu_torch.pipelines.multi_bev import run_multi_bev
    from pctpu_torch.pipelines.registration import register_pairs, run_batch_whole_registration

    n_points_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_data=n_devices // n_points_axis, n_points=n_points_axis,
                     devices=devices)
    dev0 = mesh.data_devices[0]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    # --- data-parallel preprocess over the cloud batch ---------------------
    params = SensorParams(n_scan=8, horizon_scan=64, ground_upper_scan=6, height_res=0.5)
    batch = mesh.shape["data"] * 2
    clouds = _example_cloud(batch=batch, params=params, n_points=256, device=dev0)
    run = sharded_preprocess(mesh, params, GroundConfig(), MultiBevConfig(), SingleBevConfig())
    _, multi, single = run(shard_cloud_batch(clouds, mesh))
    if multi.shape != (batch, 24, 224, 224):
        raise AssertionError(f"sharded preprocess: multi BEV of shape {tuple(multi.shape)}")

    # --- the correspondence search with its target over 'points' -----------
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((128, 3)).astype(np.float32)).to(dev0)
    t = torch.from_numpy(rng.standard_normal((256, 3)).astype(np.float32)).to(dev0)
    idx, d2 = sharded_nn_1(mesh, tile=64)(q, torch.ones(128, dtype=torch.bool, device=dev0),
                                          t, torch.ones(256, dtype=torch.bool, device=dev0))
    if not bool(torch.isfinite(d2).all()):
        raise AssertionError("sharded_nn_1: a query found no target")

    # --- a metric summed over 'data' -----------------------------------------
    totals = psum_metrics(mesh)(torch.ones((mesh.shape["data"],), device=dev0))
    if float(totals) != mesh.shape["data"]:
        raise AssertionError(f"psum_metrics: {float(totals)}")

    # --- the BEV pipeline over the same mesh ----------------------------------
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cloud_dir = os.path.join(tmp, "keyframe_point_cloud")
        os.makedirs(cloud_dir)
        n_clouds = mesh.shape["data"] * 2 + 1  # odd count: a padded batch
        for i in range(n_clouds):
            n = 200
            xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
            xyz[:, 2] = rng.uniform(-2.2, 3.0, n).astype(np.float32)
            c = make_cloud(xyz, intensity=rng.random(n).astype(np.float32),
                           row=rng.integers(0, params.n_scan, n).astype(np.int32),
                           col=rng.integers(0, params.horizon_scan, n).astype(np.int32),
                           label=np.full(n, -2, np.int32), device="cpu")
            save_cloud_pcd(os.path.join(cloud_dir, f"{i:06d}.pcd"), c)
        with open(os.path.join(tmp, "keyframe_pose.csv"), "w") as f:
            for i in range(n_clouds):
                f.write(f"{i:06d},{i * 25.0:.6f},0.000000,0.000000,0,0,0,"
                        "1.000000,0.000000,0.000000,0.000000,1.000000,0.000000,"
                        "0.000000,0.000000,1.000000\n")
        out = run_multi_bev(tmp, params, batch_size=mesh.shape["data"], write_pngs=False,
                            mesh=mesh, device=dev0)
        if out.num_clouds != n_clouds:
            raise AssertionError(f"run_multi_bev on the mesh: {out}")

    # --- the registration pipeline over the same mesh -------------------------
    # dense building clusters: every occupied 20 m top-part cell clears the
    # 20-point minimum, so the coarse stage has a real flat cloud and the
    # fine fitness is a meaningful canary
    rng = np.random.default_rng(2)
    clusters = [np.stack([cx + rng.normal(0, 2.0, 80), cy + rng.normal(0, 2.0, 80),
                          rng.uniform(0, 8, 80)], 1)
                for cx, cy in [(-25.0, -25.0), (25.0, -25.0), (-25.0, 25.0), (25.0, 25.0),
                               (0.0, 0.0)]]
    n_ground = 200
    clusters.append(np.stack([rng.uniform(-40, 40, n_ground), rng.uniform(-40, 40, n_ground),
                              rng.uniform(-2.0, -1.9, n_ground)], 1))
    pts = np.concatenate(clusters).astype(np.float32)
    lab = np.concatenate([np.full(len(pts) - n_ground, -2), np.zeros(n_ground)]).astype(np.int32)
    th = np.radians(9.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                   np.float32)
    ca = make_cloud(pts, label=lab, capacity=1024, device=dev0)
    cb = make_cloud(pts @ rot.T + np.float32([0.5, -0.4, 0.0]), label=lab, capacity=1024,
                    device=dev0)
    n_pairs = mesh.shape["data"] * 2
    cfg = RegistrationConfig(
        coarse=IcpConfig(max_correspondence_distance=10.0, max_iterations=3,
                         point_to_plane=True),
        fine=IcpConfig(max_correspondence_distance=1.0, max_iterations=5,
                       transformation_epsilon=1e-6, euclidean_fitness_epsilon=0.01),
    )
    results = register_pairs([(ca, cb, 9.0)] * n_pairs, cfg, flat_cap=1024, mesh=mesh)
    fits = [float(fine.fitness) for _, fine in results]
    if len(results) != n_pairs or not all(np.isfinite(fits)):
        raise AssertionError(f"register_pairs on the mesh: fitness {fits}")
    if not fits[0] < 10.0:
        raise AssertionError(f"fine stage diverged on the dryrun scene: {fits[0]}")

    # --- the whole-cloud driver over the same mesh ----------------------------
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cloud_dir = os.path.join(tmp, "clouds")
        os.makedirs(cloud_dir)
        save_cloud_pcd(os.path.join(cloud_dir, "000000.pcd"), ca)
        save_cloud_pcd(os.path.join(cloud_dir, "000001.pcd"), cb)
        match_file = os.path.join(tmp, "match_result.txt")
        with open(match_file, "w") as f:
            for k in range(n_pairs):
                q_i, m_i = (0, 1) if k % 2 == 0 else (1, 0)
                f.write(f"{q_i} {m_i} {9.0 if k % 2 == 0 else -9.0}\n")
        report = os.path.join(tmp, "whole_report.txt")
        counts = run_batch_whole_registration(match_file, cloud_dir, report_path=report,
                                              pair_batch=n_pairs, mesh=mesh, device=dev0)
        if sum(counts) != n_pairs:
            raise AssertionError(f"run_batch_whole_registration on the mesh: {counts}")
        with open(report) as f:
            if f.read() != "":  # the reference's empty-report quirk
                raise AssertionError("the whole driver wrote its report")

    print(f"dryrun_multichip OK: mesh={mesh.shape}, batch={batch}, "
          f"pipeline clouds={n_clouds}, nn idx[0]={int(idx[0])}, "
          f"registration pairs={n_pairs} fine fitness[0]={fits[0]:.4f}, "
          f"whole counts={counts}")
