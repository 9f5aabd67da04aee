"""CLI: pointcloud_pca_test — argv contract of reference/main.cpp:50-57
(``pointcloud_pca_test <pcd>``), the same as
``pctpu.cli.pointcloud_pca_test``; prints eigenvalues/vectors.
``--snapshot=out.png`` writes a headless render of the reference's arrow
viewer (filtered cloud red on white, principal-axis arrows eigvec×200 from
the centroid colored blue/green/red, reference/main.cpp:100-135);
``--snapshot-view=front`` for the elevation view; ``--html=out.html``
writes the same scene as a standalone interactive WebGL viewer.

Runs on the CUDA card, or on the CPU with ``--device=cpu``; without a card
and that flag it exits non-zero.  The device in use is printed to standard
error, so that standard output holds pctpu's three lines."""

import sys

import numpy as np

from pctpu_torch.cli._common import path_kw, pick_device, split_args, usage_exit
from pctpu_torch.io.pcd import load_cloud_pcd
from pctpu_torch.ops.pca import pca3d, pca_test_filter


def main(argv=None) -> int:
    pos, kw = split_args(sys.argv[1:] if argv is None else argv)
    if len(pos) < 1:
        usage_exit("Usage: pointcloud_pca_test <pcd>")
    device = pick_device(kw, file=sys.stderr)
    cloud = load_cloud_pcd(pos[0], device=device)
    # one filter pass feeds both the PCA and the optional snapshot
    xyz, keep = pca_test_filter(cloud)
    mu, vals, vecs = pca3d(xyz, keep)
    kept = int(keep.sum())
    print(f"cloud_in: {int(cloud.count)}, filter: {kept}")
    print(vals.cpu().numpy())
    print(vecs.cpu().numpy())

    snapshot = path_kw(kw, "snapshot")
    html = path_kw(kw, "html")
    if snapshot or html:
        pts, ok = xyz.cpu().numpy(), keep.cpu().numpy()
        c, v = mu.cpu().numpy(), vecs.cpu().numpy()  # eigenvectors ascending, columns like Eigen
    if snapshot:
        from pctpu_torch.io.png import write_rgb_png
        from pctpu_torch.ops.render import Layer, render_snapshot, segment_points

        tips = [c + 200.0 * v[:, i] for i in range(3)]
        # arrow colors follow the reference: col0 blue, col1 green, col2 red
        layers = [
            Layer(pts, (255, 0, 0), mask=ok),
            Layer(segment_points(c[None], tips[0][None]), (0, 0, 255)),
            Layer(segment_points(c[None], tips[1][None]), (0, 255, 0)),
            Layer(segment_points(c[None], tips[2][None]), (255, 0, 0)),
        ]
        img = render_snapshot(
            layers, view=kw.get("snapshot_view", "top"),
            background=(255, 255, 255), device=device,
        )
        write_rgb_png(snapshot, img)
    if html:
        from pctpu_torch.io.html_viewer import write_pca_test_html

        write_pca_test_html(html, pts, ok, c, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
