"""The docs/API.md quickstart against pctpu_torch (the PyTorch/CUDA port
of pctpu), runnable: library-level use without any CLI or dataset tree —
build a cloud, round-trip it through PCD, run the preprocess step, and
register a pair.  The steps of ``examples/library_quickstart.py``.

Run:  python examples/torch_library_quickstart.py [workdir] [--device=cuda|cpu]

``--device`` (default ``cuda``) is where the tensors live; without a card
the quickstart exits 2 unless ``--device=cpu`` is given.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np

# the checkout's pctpu_torch, when run as a script from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_points(rng, n_clusters: int = 10):
    """Building clusters (label -2) over a dense ground plane (label 0)."""
    pts, labels = [], []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(-50, 50, 2)
        n = 150
        pts.append(np.stack([cx + rng.normal(0, 2.5, n), cy + rng.normal(0, 2.5, n),
                             rng.uniform(0, 9, n)], axis=1))
        labels.append(np.full(n, -2))
    n_ground = 1200
    pts.append(np.stack([rng.uniform(-70, 70, n_ground), rng.uniform(-70, 70, n_ground),
                         rng.uniform(-2.0, -1.9, n_ground)], axis=1))
    labels.append(np.zeros(n_ground))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(labels).astype(np.int32))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if not a.startswith("--")]
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    if device not in ("cuda", "cpu"):
        print(f"--device must be cuda or cpu (got {device!r})", file=sys.stderr)
        return 1

    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("torch_library_quickstart: no CUDA card; pass --device=cpu to run on the CPU",
              file=sys.stderr)
        return 2
    workdir = pos[0] if pos else tempfile.mkdtemp(prefix="pctpu_torch_quickstart_")
    os.makedirs(workdir, exist_ok=True)

    from pctpu_torch import get_sensor_params, make_cloud
    from pctpu_torch.io.pcd import load_cloud_pcd, save_cloud_pcd
    from pctpu_torch.ops.preprocess import preprocess_batch

    # --- build + PCD round trip ------------------------------------------
    params = get_sensor_params("HDL_64E")
    rng = np.random.default_rng(0)
    xyz, labels = synth_points(rng)
    n = len(xyz)
    cloud = make_cloud(
        xyz,
        intensity=rng.random(n).astype(np.float32),
        row=rng.integers(0, params.n_scan, n).astype(np.int32),
        col=rng.integers(0, params.horizon_scan, n).astype(np.int32),
        label=np.full(n, -2, np.int32),
        capacity=params.grid_size,
        device=device,
    )
    pcd_path = os.path.join(workdir, "000000.pcd")
    save_cloud_pcd(pcd_path, cloud)
    cloud = load_cloud_pcd(pcd_path, capacity=params.grid_size, device=device)
    print(f"round-tripped {int(cloud.count)} points through {pcd_path} on {device}")

    # --- one preprocess step (ordering -> ground -> both BEVs) -----------
    batch = cloud.replace(**{f: getattr(cloud, f)[None]
                             for f in ("xyz", "intensity", "row", "col", "t", "label")},
                          count=torch.tensor([int(cloud.count)], device=device))
    labeled, multi_bev_u8, single_bev_u8 = preprocess_batch(batch, params)
    n_ground_marked = int((labeled.label[0] == 0).sum())
    print(f"multi-BEV {tuple(multi_bev_u8.shape)} single-BEV {tuple(single_bev_u8.shape)}, "
          f"{n_ground_marked} points marked ground")
    assert tuple(multi_bev_u8.shape) == (1, 24, 224, 224)
    assert tuple(single_bev_u8.shape) == (1, 224, 224)

    # --- two-stage registration of a known-transform pair ----------------
    from pctpu_torch.config import RegistrationConfig
    from pctpu_torch.pipelines.registration import register_pair

    true_yaw = 12.0
    th = math.radians(true_yaw)
    rot = np.array([[math.cos(th), -math.sin(th), 0],
                    [math.sin(th), math.cos(th), 0], [0, 0, 1]], np.float32)
    cloud_a = make_cloud(xyz, label=labels, capacity=4096, device=device)
    cloud_b = make_cloud(xyz @ rot.T + np.float32([1.0, -0.5, 0.0]), label=labels,
                         capacity=4096, device=device)
    best_coarse, fine = register_pair(cloud_a, cloud_b, angle_guess_deg=10.0,
                                      cfg=RegistrationConfig(), flat_cap=4096)
    t = np.asarray(fine.transform)
    yaw = math.degrees(math.atan2(t[1, 0], t[0, 0]))
    print(f"recovered yaw {yaw:.3f} deg (truth {true_yaw}), fitness {float(fine.fitness):.2e}")
    assert abs(yaw - true_yaw) < 0.5
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
