"""Dataset keyframe selectors: KITTI, MulRan, Oxford Radar RobotCar (the
port of ``pctpu/pipelines/selectors.py``).

Reference binaries: kitti_point_cloud_select
(reference/KittiPointCloudSelect.cpp:357-477), mulran_point_cloud_select
(reference/MulranPointCloudSelect.cpp:248-377), oxford_point_cloud_select
(reference/OxfordPointCloudSelect.cpp:331-455).

Output contract (identical for all three): ``selected_keyframes_X.XXm/`` with
``keyframe_point_cloud/%06d.pcd`` (named by *keyframe* index),
``keyframe_pose.csv`` (first field = *source* cloud index) and
``keyframe_pose_format.csv``.

These tools read binaries and write PCDs and CSVs on the host, in numpy, as
pctpu does: no tensor reaches a device, so they take no device and never
initialise CUDA.
"""

from __future__ import annotations

import functools
import os
import shutil

import numpy as np

from pctpu_torch.geom.se3 import (
    Pose6f,
    eigen_euler_angles_xyz,
    eigen_euler_angles_zyx,
    interpolate_pose,
    quat_from_matrix,
)
from pctpu_torch.io import kitti, mulran, oxford
from pctpu_torch.io.pcd import write_pcd
from pctpu_torch.io.poses import format_pose_entry, write_pose_format_file
from pctpu_torch.ops.select import greedy_keyframe_mask
from pctpu_torch.runtime.writer import AsyncWriter
from pctpu_torch.utils import logging as log


def _output_dirs(dataset_dir: str, interval: float, resume: bool) -> tuple[str, str]:
    root = dataset_dir.rstrip("/") + "/"
    # fmt::format("{:2.2f}") of the interval (reference/KittiPointCloudSelect.cpp:131)
    out_root = f"{root}selected_keyframes_{interval:2.2f}m/"
    cloud_dir = out_root + "keyframe_point_cloud/"
    for d in (out_root, cloud_dir):
        if os.path.isdir(d) and not resume:
            shutil.rmtree(d)
        os.makedirs(d, exist_ok=True)
    return out_root, cloud_dir


def _dist32(a: np.ndarray, b: np.ndarray) -> float:
    d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
    return float(np.sqrt(np.sum(d * d, dtype=np.float32)))


def run_kitti_select(
    dataset_dir: str, interval: float = 2.0, resume: bool = False
) -> int:
    """KITTI selector; returns the number of keyframes written.

    Poses pair 1:1 with clouds (no interpolation,
    reference/KittiPointCloudSelect.cpp:444); euler columns come from
    Eigen eulerAngles(0,1,2) (:292)."""
    root = dataset_dir.rstrip("/") + "/"
    out_root, cloud_dir = _output_dirs(root, interval, resume)
    log.info(f"Using keyframe_dist_interval = {interval}m. ")

    lidar_poses = kitti.read_global_poses(root + "global_pose.txt")
    stamps = kitti.read_timestamps(root + "times.txt")
    log.info(f"Finish reading all gt pose, total {len(lidar_poses)} entries. ")
    if len(lidar_poses) != len(stamps):
        raise ValueError(
            "Numbers of gt poses do NOT agree with the number of velodyne point clouds."
        )

    write_pose_format_file(out_root + "keyframe_pose_format.csv")

    positions = np.array([t[:3, 3] for t in lidar_poses], np.float32).reshape(-1, 3)
    keep = greedy_keyframe_mask(positions, interval)
    keyframe_idx = 0
    last = np.array([-1e10, -1e10, 0.0], np.float32)
    with open(out_root + "keyframe_pose.csv", "w") as f_poses, AsyncWriter() as writer:
        for cloud_idx in range(len(stamps)):
            t = lidar_poses[cloud_idx]
            pos = t[:3, 3].astype(np.float32)
            if not keep[cloud_idx]:
                continue
            log.info(
                f"Saving keyframe: {keyframe_idx}, dist to last keyframe: {_dist32(pos, last)}"
            )
            rotation = t[:3, :3]
            euler = eigen_euler_angles_xyz(rotation)
            pose = Pose6f(
                x=np.float32(t[0, 3]),
                y=np.float32(t[1, 3]),
                z=np.float32(t[2, 3]),
                roll=np.float32(euler[0]),
                pitch=np.float32(euler[1]),
                yaw=np.float32(euler[2]),
                rotation_matrix=rotation,
                rotation_quat=quat_from_matrix(rotation),
            )
            out_pcd = f"{cloud_dir}{keyframe_idx:06d}.pcd"
            if not (resume and os.path.exists(out_pcd)):
                points = kitti.read_bin(f"{root}velodyne/{cloud_idx:06d}.bin")
                fields = kitti.structure_cloud(points)
                # the packed-pcd encode + disk write overlaps the next bin read
                writer.submit(functools.partial(write_pcd, out_pcd, fields))
            f_poses.write(format_pose_entry(cloud_idx, pose))
            keyframe_idx += 1
            last = pos
    log.info("Done. ")
    return keyframe_idx


def run_kitti_raw_select(dataset_dir: str) -> int:
    """The dead raw-variant KITTI selector
    (reference/KittiRawPointCloudSelect.cpp:315-373; not in the
    reference CMakeLists — kept for inventory completeness).  Differences
    from :func:`run_kitti_select`, all reproduced here:

      * fixed 2.0 m keyframe interval and FIXED output layout
        ``selected_keyframes/`` (no interval suffix, no format file,
        always recreated — :55, :65-67, :318-322);
      * poses are the ``global_pose.txt`` rows used DIRECTLY (no
        camera→lidar conjugation), with the axis shuffle
        x=T(0,3), y=T(2,3), z=T(1,3) and Eigen eulerAngles(2,1,0)
        (roll=e[2], pitch=e[1], yaw=e[0]) (:250-259);
      * pose CSV rows are just ``x,y,z,roll,pitch,yaw`` at %.6f — no
        leading cloud index, no rotation-matrix columns (:356-358);
      * ring segmentation has no minimum-length guard
        (:func:`pctpu_torch.io.kitti.assign_rings_raw`), and up to 64*2250
        points are read per .bin (:141);
      * a missing .bin saves an EMPTY cloud (0 points) after a stderr
        complaint instead of aborting (:135-138).

    Divergences from C UB (README ledger): the reference's EOF read loop
    (:142-152) pushes one trailing uninitialized point per .bin and its
    ``t`` field is never written (garbage bytes in the saved PCD); we
    read exact records and zero-fill ``t``.
    """
    root = dataset_dir.rstrip("/") + "/"
    out_root = root + "selected_keyframes/"
    cloud_dir = out_root + "keyframe_point_cloud/"
    for d in (out_root, cloud_dir):
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d, exist_ok=True)

    gt = kitti.read_raw_gt_poses(root + "global_pose.txt")
    log.info(f"Finish reading all gt pose, total {len(gt)} entries. ")
    stamps = kitti.read_timestamps(root + "times.txt")
    log.info(f"Finish reading all cloud timestamps, total {len(stamps)} entries. ")
    if len(gt) != len(stamps):
        raise ValueError(
            "Numbers of gt poses do NOT agree with the number of velodyne point clouds."
        )

    # pose members are f32 casts of the (axis-shuffled) double entries; the
    # keyframe distance is computed over them in f32 (:300-306)
    positions = np.stack(
        [gt[:, 0, 3], gt[:, 2, 3], gt[:, 1, 3]], axis=1
    ).astype(np.float32)
    keep = greedy_keyframe_mask(positions, 2.0)

    keyframe_idx = 0
    last = np.array([-1e10, -1e10, 0.0], np.float32)
    with open(out_root + "keyframe_pose.csv", "w") as f_poses, AsyncWriter() as writer:
        for cloud_idx in range(len(stamps)):
            if not keep[cloud_idx]:
                continue
            pos = positions[cloud_idx]
            log.info(
                f"Saving keyframe: {keyframe_idx}, dist to last keyframe: "
                f"{_dist32(pos, last)}"
            )
            euler = eigen_euler_angles_zyx(gt[cloud_idx, :3, :3])
            vals = [pos[0], pos[1], pos[2],
                    np.float32(euler[2]), np.float32(euler[1]), np.float32(euler[0])]
            out_pcd = f"{cloud_dir}{keyframe_idx:06d}.pcd"
            bin_path = f"{root}velodyne/{cloud_idx:06d}.bin"
            if os.path.exists(bin_path):
                points = kitti.read_bin(bin_path, kitti.RAW_MAX_NUM_POINTS)
                fields = kitti.structure_cloud(
                    points, rings=kitti.assign_rings_raw(points)
                )
            else:
                log.error(f"Failed to open point cloud file: {bin_path}")
                fields = {
                    k: np.zeros(0, v.dtype)
                    for k, v in kitti.structure_cloud(
                        np.zeros((0, 4), np.float32)
                    ).items()
                }
            writer.submit(functools.partial(write_pcd, out_pcd, fields))
            f_poses.write(",".join(f"{float(v):.6f}" for v in vals) + "\n")
            keyframe_idx += 1
            last = pos
    log.info("Done. ")
    return keyframe_idx


def _run_interpolating_select(
    out_root: str,
    cloud_dir: str,
    interval: float,
    gt_stamps: np.ndarray,
    gt_poses: list[Pose6f],
    cloud_stamps: np.ndarray,
    extract_fn,
    bin_name_fn,
    resume: bool = False,
    euler: str = "utility",
) -> int:
    """Shared MulRan/Oxford skeleton: per-cloud pose by linear+slerp
    interpolation between bracketing GT poses
    (reference/MulranPointCloudSelect.cpp:320-346).  ``euler`` selects
    the interpolated-pose euler convention: MulRan uses Utility.h's custom
    extraction, Oxford's local Pose6f keeps Eigen ``eulerAngles(2,1,0)``
    (see ``interpolate_pose``)."""
    write_pose_format_file(out_root + "keyframe_pose_format.csv")

    # pass 1: interpolate a pose for every cloud that has bracketing GT
    # (monotone cursor like the reference, :320-346), then gate with the
    # shared greedy keyframe op (sentinel = origin, :318)
    candidates: list[tuple[int, int, object]] = []  # (cloud_idx, stamp, pose)
    last_gt_idx = 1
    for cloud_idx in range(len(cloud_stamps)):
        stamp = int(cloud_stamps[cloud_idx])
        found = False
        for gt_idx in range(last_gt_idx, len(gt_stamps)):
            if gt_stamps[gt_idx - 1] <= stamp <= gt_stamps[gt_idx]:
                last_gt_idx = gt_idx
                found = True
                break
        if not found:
            log.error(f"Could not find pose for cloud at timestamp: {stamp}")
            continue
        # duplicate GT stamps give 0/0 in the reference's double math
        # (NaN pose, frame still processed) — keep that, don't raise
        with np.errstate(invalid="ignore", divide="ignore"):
            lam = float(
                np.float64(stamp - gt_stamps[gt_idx - 1])
                / np.float64(gt_stamps[gt_idx] - gt_stamps[gt_idx - 1])
            )
        pose = interpolate_pose(gt_poses[gt_idx - 1], gt_poses[gt_idx], lam,
                                euler=euler)
        candidates.append((cloud_idx, stamp, pose))

    positions = np.array(
        [p.position() for _, _, p in candidates], np.float32
    ).reshape(-1, 3)
    keep = greedy_keyframe_mask(positions, interval, sentinel=(0.0, 0.0, 0.0))

    keyframe_idx = 0
    last = np.zeros(3, np.float32)
    with open(out_root + "keyframe_pose.csv", "w") as f_poses, AsyncWriter() as writer:
        for ci, (cloud_idx, stamp, pose) in enumerate(candidates):
            if not keep[ci]:
                continue
            pos = pose.position()
            log.info(
                f"Saving keyframe: {keyframe_idx}, dist to last keyframe: {_dist32(pos, last)}"
            )
            out_pcd = f"{cloud_dir}{keyframe_idx:06d}.pcd"
            if not (resume and os.path.exists(out_pcd)):
                fields = extract_fn(bin_name_fn(stamp))
                if fields is not None:
                    # packed-pcd encode + write overlaps the next bin read
                    writer.submit(functools.partial(write_pcd, out_pcd, fields))
            f_poses.write(format_pose_entry(cloud_idx, pose))
            keyframe_idx += 1
            last = pos
    log.info("Done. ")
    return keyframe_idx


def run_mulran_select(
    dataset_dir: str, interval: float = 2.0, resume: bool = False
) -> int:
    root = dataset_dir.rstrip("/") + "/"
    out_root, cloud_dir = _output_dirs(root, interval, resume)
    log.info(f"Using keyframe_dist_interval = {interval}m. ")
    stamps, mats = mulran.read_global_poses(root + "global_pose.csv")
    poses = [Pose6f.from_matrix(m[:3, :3], m[:3, 3]) for m in mats]
    cloud_stamps = mulran.read_timestamps(root + "sensor_data/ouster_front_stamp.csv")

    def extract(path):
        if not os.path.exists(path):
            log.error(f"Failed to open point cloud file: {path}")
            return None
        return mulran.read_bin(path)

    return _run_interpolating_select(
        out_root,
        cloud_dir,
        interval,
        stamps,
        poses,
        cloud_stamps,
        extract,
        lambda s: f"{root}sensor_data/Ouster/{s:010d}.bin",
        resume=resume,
    )


def run_oxford_select(
    dataset_dir: str, interval: float = 2.0, resume: bool = False
) -> int:
    root = dataset_dir.rstrip("/") + "/"
    out_root, cloud_dir = _output_dirs(root, interval, resume)
    log.info(f"Using keyframe_dist_interval = {interval}m. ")
    stamps, rots, trans, rpys = oxford.read_ins_poses(root + "gps/ins.csv")
    poses = []
    for r, t, rpy in zip(rots, trans, rpys):
        # the reference keeps the raw INS rpy floats (:258-264), not re-derived
        poses.append(
            Pose6f(
                x=np.float32(t[0]),
                y=np.float32(t[1]),
                z=np.float32(t[2]),
                roll=np.float32(rpy[0]),
                pitch=np.float32(rpy[1]),
                yaw=np.float32(rpy[2]),
                rotation_matrix=r,
                rotation_quat=quat_from_matrix(r),
            )
        )
    cloud_stamps = _read_oxford_stamps(root + "velodyne_left.timestamps")

    def extract(path):
        if not os.path.exists(path):
            log.error(f"Failed to open point cloud file: {path}")
            return None
        return oxford.read_bin(path)

    return _run_interpolating_select(
        out_root,
        cloud_dir,
        interval,
        stamps,
        poses,
        cloud_stamps,
        extract,
        lambda s: f"{root}velodyne_left/{s:010d}.bin",
        resume=resume,
        # Oxford's LOCAL Pose6f::interpolate keeps the Eigen eulerAngles
        # call Utility.h comments out (OxfordPointCloudSelect.cpp:84-99)
        euler="eigen_zyx",
    )


def _read_oxford_stamps(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok:
                out.append(int(tok[0]))
    return np.sort(np.asarray(out, np.int64), kind="stable")
