"""cloud_manip: single-cloud rigid transform + float BEV export (the port of
``pctpu/pipelines/cloud_manip.py``).

Reference: reference/CloudManip.cpp:111-161.  Loads a pcd, applies a
translation+yaw transform, writes input/output float BEVs (csv + png, no
ground filtering — CloudManip.cpp:88) and both pcds.  The interactive PCL
viewer (input red, output green, dark-gray background, CloudManip.cpp:143-158)
is replaced by an optional headless snapshot PNG of the same scene
(``snapshot=``) and an optional standalone HTML viewer (``html=``).  Every
file is byte-equal to pctpu's.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from pctpu_torch.cloud import stack_clouds
from pctpu_torch.config import FloatBevConfig
from pctpu_torch.io.csvfmt import write_csv
from pctpu_torch.io.pcd import load_cloud_pcd, save_cloud_pcd
from pctpu_torch.io.png import write_gray_png
from pctpu_torch.ops.bev import float_bev
from pctpu_torch.ops.transform import make_rigid_transform, transform_cloud


def run_cloud_manip(
    input_filename: str,
    tx: float,
    ty: float,
    tz: float,
    yaw_deg: float,
    output_dir: str = ".",
    snapshot: str | None = None,
    snapshot_view: str = "top",
    html: str | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Returns {'input': bev, 'output': bev} float BEVs and writes all files.

    Output naming matches the reference exactly: ``<short>_input.csv``,
    ``<short>_input.csv.png`` (the reference appends .png to the csv name,
    CloudManip.cpp:108), and ``<short>_{input,output}.pcd``.
    """
    cloud = load_cloud_pcd(input_filename, device=device)
    theta = yaw_deg / 180.0 * math.pi
    transform = make_rigid_transform(tx, ty, tz, theta)
    out_cloud = transform_cloud(cloud, transform)

    # both clouds' BEVs in one call (each cloud its own image)
    bevs = float_bev(stack_clouds([cloud, out_cloud]), FloatBevConfig(filter_ground=False))
    bev_in, bev_out = bevs.cpu().numpy()

    short = os.path.basename(input_filename)
    base = os.path.join(output_dir, short)
    write_csv(base + "_input.csv", bev_in)
    write_gray_png(base + "_input.csv.png", bev_in)
    write_csv(base + "_output.csv", bev_out)
    write_gray_png(base + "_output.csv.png", bev_out)
    save_cloud_pcd(base + "_input.pcd", cloud)
    save_cloud_pcd(base + "_output.pcd", out_cloud)

    if snapshot is not None or html is not None:
        xyz_in, mask_in = cloud.xyz.cpu().numpy(), cloud.valid_mask().cpu().numpy()
        xyz_out, mask_out = out_cloud.xyz.cpu().numpy(), out_cloud.valid_mask().cpu().numpy()

    if snapshot is not None:
        from pctpu_torch.io.png import write_rgb_png
        from pctpu_torch.ops.render import Layer, render_snapshot

        img = render_snapshot(
            [Layer(xyz_in, (255, 0, 0), mask=mask_in),
             Layer(xyz_out, (0, 255, 0), mask=mask_out)],
            view=snapshot_view,
            background=(13, 13, 13),  # the viewer's 0.05 gray
            device=device,
        )
        write_rgb_png(snapshot, img)

    if html is not None:
        from pctpu_torch.io.html_viewer import write_cloud_manip_html

        write_cloud_manip_html(html, xyz_in, mask_in, xyz_out, mask_out)
    return {"input": bev_in, "output": bev_out}
