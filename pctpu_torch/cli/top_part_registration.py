"""CLI: top_part_registration — single-pair two-stage registration, the
argv contract of reference/TopPartRegistration.cpp:256-455
(``top_part_registration <pcd_1> <pcd_2> <yaw_guess_deg>``), the same as
``pctpu.cli.top_part_registration``, including the per-stage ``[TIME]``
reports (:318-326) and ``--flat-cap=N``.  The interactive viewer (flat
cloud red with every-10th-point normal whiskers of length 2 on black,
TopPartRegistration.cpp:367-385) is replaced by an optional headless
snapshot PNG of the same scene (``--snapshot=out.png``,
``--snapshot-view=top|front``) and/or a standalone interactive WebGL viewer
(``--html=out.html``).

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed."""

import sys

import numpy as np

from pctpu_torch.cli._common import int_kw, path_kw, pick_device, split_args, usage_exit
from pctpu_torch.io.pcd import load_cloud_pcd
from pctpu_torch.pipelines.registration import register_pair
from pctpu_torch.runtime.profiler import StageTimer
from pctpu_torch.utils import logging as log


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 3:
        usage_exit("Usage: top_part_registration <pcd_1> <pcd_2> <yaw_guess_deg>")
    device = pick_device(kw)
    c1 = load_cloud_pcd(pos[0], device=device)
    c2 = load_cloud_pcd(pos[1], device=device)
    cap = int_kw(kw, "flat_cap", 32768)
    timer = StageTimer()
    best, fine = register_pair(c1, c2, float(pos[2]), flat_cap=cap, timer=timer)
    log.info(f"[TIME] 1st stage (top extraction + normals + coarse ICP x2): "
             f"{timer.totals_ms.get('coarse', 0.0)}ms. ")
    log.info(
        f"best coarse result: \nfitness score: {float(best.fitness)}\n"
        f"trans: \n{np.asarray(best.transform)}. "
    )
    log.info(f"[TIME] 2nd stage (fine 3D ICP): {timer.totals_ms.get('fine', 0.0)}ms. ")
    log.info(
        f"is icp converged: {bool(fine.converged)}, fitness score: "
        f"{float(fine.fitness)}, trans: \n{np.asarray(fine.transform)}. "
    )

    snapshot = path_kw(kw, "snapshot")
    html = path_kw(kw, "html")
    if snapshot or html:
        from pctpu_torch.config import RegistrationConfig
        from pctpu_torch.ops.normals2d import normals_2d
        from pctpu_torch.ops.topflatten import extract_top_and_flatten
        from pctpu_torch.ops.voxel import voxel_downsample

        # re-derives stage-1 prep for the render (debug path), on the card;
        # truncation to flat_cap mirrors the registration's flat stage so the
        # scene matches what the registration actually consumed
        cfg = RegistrationConfig()
        fx, fm, _ = extract_top_and_flatten(c1)
        vx, vm, _ = voxel_downsample(fx[:cap], fm[:cap], cfg.voxel_leaf)
        nrm, _, n_ok = normals_2d(vx, vm, radius=cfg.normal_radius)
        pts = vx.cpu().numpy()
        valid = vm.cpu().numpy()
        ok = (vm & n_ok).cpu().numpy()
        normals = nrm.cpu().numpy()
    if snapshot:
        from pctpu_torch.io.png import write_rgb_png
        from pctpu_torch.ops.render import Layer, render_snapshot, segment_points

        every10 = ok & (np.arange(pts.shape[0]) % 10 == 0)
        whiskers = segment_points(pts[every10], pts[every10] + 2.0 * normals[every10])
        img = render_snapshot(
            [Layer(pts, (255, 0, 0), mask=valid), Layer(whiskers, (255, 255, 255))],
            view=kw.get("snapshot_view", "top"),
            background=(0, 0, 0),
            device=device,
        )
        write_rgb_png(snapshot, img)
    if html:
        from pctpu_torch.io.html_viewer import write_top_part_html

        write_top_part_html(html, pts, valid, normals, ok)
    return 0


if __name__ == "__main__":
    sys.exit(main())
