"""End-to-end walkthrough of pctpu_torch (the PyTorch/CUDA port of pctpu)
on a synthetic MulRan-layout dataset: the stages of
``examples/end_to_end_demo.py``, through the port's CLIs.

Builds a miniature dataset tree, then runs the three stages a user of the
reference toolchain runs (the reference's README, usage §1-§4):

  1. mulran_point_cloud_select  — keyframe extraction (2 m gate, pose interp)
  2. batch_multi_bev_gen        — ground removal + single/multi BEV + labels
  3. batch_top_part_registration — two-stage ICP over a match list

and writes an interactive viewer of the first keyframe's cloud_manip scene.

Run:  python examples/torch_end_to_end_demo.py [workdir] [--device=cuda|cpu]

``--device`` (default ``cuda``) is where the BEV and registration stages
run; without a card the demo exits 2 unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

# the checkout's pctpu_torch, when run as a script from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_mulran_tree(root: str, n_clouds: int = 8, n_points: int = 4000) -> None:
    """MulRan layout: ``sensor_data/Ouster/<stamp>.bin`` clouds,
    ``sensor_data/ouster_front_stamp.csv``, timestamped ``global_pose.csv``
    (reference/MulranPointCloudSelect.cpp:96-133, 135-228).  Cloud stamps
    fall between ground-truth pose stamps, so the selector interpolates
    poses.  (A copy of the pctpu demo's tree: the same bytes.)"""
    os.makedirs(f"{root}/sensor_data/Ouster", exist_ok=True)
    rng = np.random.default_rng(0)

    # one static world: clusters + a ground plane, seen from a moving pose
    clusters = []
    for _ in range(14):
        cx, cy = rng.uniform(-45, 45, 2)
        n = 120
        clusters.append(np.stack([cx + rng.normal(0, 2.0, n), cy + rng.normal(0, 2.0, n),
                                  rng.uniform(0.0, 7.0, n)], 1))
    ng = n_points - 14 * 120
    clusters.append(np.stack([rng.uniform(-60, 60, ng), rng.uniform(-60, 60, ng),
                              rng.uniform(-1.95, -1.85, ng)], 1))
    world = np.concatenate(clusters).astype(np.float32)

    base = 1_560_000_000_000_000_000
    step = 100_000_000  # 100 ms between ground-truth poses

    # poses at t = base + i·step, x = 2.5·i: every interpolated keyframe
    # candidate is ≈ 2.5 m from the previous one and passes the 2 m gate
    with open(f"{root}/global_pose.csv", "w") as f:
        for i in range(n_clouds + 1):
            yaw = np.radians(3.0 * i)
            c, s = np.cos(yaw), np.sin(yaw)
            x = 2.5 * i
            vals = [c, -s, 0.0, x, s, c, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0]
            f.write(f"{base + i * step}," + ",".join(f"{v:.9f}" for v in vals) + "\n")

    # clouds halfway between consecutive pose stamps, seen from the
    # interpolated viewpoint
    stamps = []
    for i in range(n_clouds):
        t_ns = base + i * step + step // 2
        x = 2.5 * i + 1.25
        yaw = np.radians(3.0 * i + 1.5)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        local = (world - np.float32([x, 0, 0])) @ rot
        pts = np.zeros((len(local), 4), np.float32)
        pts[:, :3] = local
        pts[:, 3] = rng.random(len(local)).astype(np.float32) * 0.9 + 0.05
        pts.astype(np.float32).tofile(f"{root}/sensor_data/Ouster/{t_ns:010d}.bin")
        stamps.append(t_ns)

    with open(f"{root}/sensor_data/ouster_front_stamp.csv", "w") as f:
        for t_ns in stamps:
            f.write(f"{t_ns}\n")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if not a.startswith("--")]
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    if device not in ("cuda", "cpu"):
        print(f"--device must be cuda or cpu (got {device!r})", file=sys.stderr)
        return 1

    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("torch_end_to_end_demo: no CUDA card; pass --device=cpu to run on the CPU",
              file=sys.stderr)
        return 2
    work = pos[0] if pos else tempfile.mkdtemp(prefix="pctpu_torch_demo_")
    dataset = os.path.join(work, "dataset")
    os.makedirs(dataset, exist_ok=True)
    print(f"[demo] building synthetic MulRan tree under {dataset}")
    build_mulran_tree(dataset)

    from pctpu_torch.cli.batch_multi_bev_gen import main as bev_main
    from pctpu_torch.cli.batch_top_part_registration import main as reg_main
    from pctpu_torch.cli.mulran_point_cloud_select import main as select_main

    print("[demo] 1/3 mulran_point_cloud_select (2 m keyframe gate)")
    assert select_main([dataset, "2.0"]) == 0
    keyframes = os.path.join(dataset, "selected_keyframes_2.00m")
    n_kf = len(os.listdir(os.path.join(keyframes, "keyframe_point_cloud")))
    print(f"[demo]     -> {n_kf} keyframes")

    print(f"[demo] 2/3 batch_multi_bev_gen (ground removal + BEVs + labels) on {device}")
    assert bev_main([keyframes, "OS1_64", "--no-pngs", f"--device={device}"]) == 0
    n_bev = len(os.listdir(os.path.join(keyframes, "output_multi_bev", "binary")))
    print(f"[demo]     -> {n_bev} multi-BEV binaries + keyframe_label.csv")

    print(f"[demo] 3/3 batch_top_part_registration (two-stage ICP) on {device}")
    match_file = os.path.join(work, "match_result.txt")
    with open(match_file, "w") as f:
        f.write("0 1 3.0\n1 2 3.0\n")
    report = os.path.join(work, "icp_precision_report.txt")
    assert reg_main([match_file, os.path.join(keyframes, "keyframe_point_cloud"),
                     f"--report={report}", "--flat_cap=8192", f"--device={device}"]) == 0
    print(f"[demo]     -> {report}:")
    for line in open(report):
        print(f"[demo]        {line.strip()}  (diff_xy m, diff_yaw deg)")

    # an interactive viewer of the first keyframe's manip scene (open
    # viewer.html in a browser; the reference's PCLVisualizer session,
    # CloudManip.cpp:143-158)
    from pctpu_torch.pipelines.cloud_manip import run_cloud_manip

    kf_dir = os.path.join(keyframes, "keyframe_point_cloud")
    first_pcd = os.path.join(kf_dir, sorted(os.listdir(kf_dir))[0])
    viewer = os.path.join(work, "viewer.html")
    run_cloud_manip(first_pcd, 1.0, 2.0, 0.0, 30.0, output_dir=work, html=viewer,
                    device=device)
    print(f"[demo]     -> interactive viewer: {viewer}")
    print("[demo] done — outputs under", keyframes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
