"""The reference-parity harness — the port of ``scripts/run_reference_parity.py``.

    python -m pctpu_torch.experiments.reference_parity [--workdir DIR] [--keep]
        [--json PATH] [--build-reference] [--device=cuda|cpu]

With ``PCTPU_REFERENCE`` naming a checkout of the reference C++ toolchain
(soytony/Point-Cloud-Preprocessing-Tools), on a machine with cmake, PCL,
OpenCV and Boost, it builds that checkout out of tree, writes a miniature
KITTI-layout dataset, and runs the five BASELINE.json configs —
kitti_point_cloud_select, batch_multi_bev_gen HDL_64E, cloud_manip,
batch_cloud_manip, batch_top_part_registration — through the reference and
through ``python -m pctpu_torch.cli.<tool>`` (with ``--device`` where the
tool takes one), judging them by byte, pixel and degree diffs against the
acceptance window (1 px, 0.5°).  The reference is read from that variable
only: unset, the reference tier is skipped.

Without the variable or those prerequisites it falls back to the
native-oracle tier: the port's KITTI selector and ``batch_multi_bev_gen
HDL_64E`` on the device asked for, over five frames, and every written
multi-BEV, single-BEV CSV and label PCD byte-diffed against
``native/ref_oracle.cpp`` (``experiments.oracle``).

The flags are the script's; ``--device`` (default ``cuda``; exit 2 without
a card, never a fall-back to the CPU) is where the port's CLIs run, and the
verdict JSON (``--json``) carries it with the card's name and power limit.
Exit 1 when any comparison is outside the window (a ``BYTES-DIFF`` in the
native-oracle tier).

The KITTI tree (``make_kitti_tree``) and the artifact comparison
(``compare_kitti_artifacts``) are the port's copies of pctpu's test helpers
``tests/fixtures.py`` and ``tests/native_oracle.py``, which import pctpu.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
ACCEPT_PX = 1.0       # BEV pixel deviation window (BASELINE.json:5)
ACCEPT_YAW_DEG = 0.5  # yaw deviation window
# the port's CLIs that put tensors on a device; the selectors run on the host
DEVICE_TOOLS = ("batch_multi_bev_gen", "cloud_manip", "batch_cloud_manip",
                "batch_top_part_registration")
REFERENCE_TOOLS = ("kitti_point_cloud_select", "batch_multi_bev_gen", "cloud_manip",
                   "batch_cloud_manip", "batch_top_part_registration")


def log(msg: str) -> None:
    print(f"[parity] {msg}", flush=True)


# --- the dataset: the port's copy of tests/fixtures.make_kitti_tree ---------


def synth_kitti_scan(rng, rings: int = 6, per_ring: int = 1300) -> np.ndarray:
    """An (N, 4) float32 scan whose azimuth pattern drives the reference's
    ring segmentation: each ring sweeps azimuth from +179° down to -179°, so
    ring boundaries are the (az <= 0 → az > 0) flips, and per_ring > 0.6 ×
    2083 passes the ring-length guard (reference/KittiPointCloudSelect.cpp:218)."""
    pts = []
    for ring in range(rings):
        az = np.linspace(179.0, -179.0, per_ring)
        # elevations that put z inside the 24 BEV layers of HDL-64E
        elev = np.radians(-0.5 + ring * 0.6)
        r = rng.uniform(3.0, 60.0, per_ring)
        x = r * np.cos(np.radians(az))
        y = r * np.sin(np.radians(az))
        z = r * np.tan(elev) + rng.normal(0, 0.05, per_ring)
        i = rng.random(per_ring)
        pts.append(np.stack([x, y, z, i], axis=1))
    return np.concatenate(pts).astype(np.float32)


def make_kitti_tree(root: str, num_frames: int = 6, spacing: float = 3.0) -> None:
    """A KITTI-layout dataset: velodyne/*.bin + times.txt + global_pose.txt,
    the poses advancing ``spacing`` metres a frame along the lidar's +x, so a
    2 m keyframe gate keeps every frame."""
    from pctpu_torch.io import kitti

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    cam_rows = []
    a_inv = np.linalg.inv(kitti.CAM_WRT_LIDAR)
    for idx in range(num_frames):
        scan = synth_kitti_scan(rng)
        scan.tofile(os.path.join(root, "velodyne", f"{idx:06d}.bin"))
        t_lidar = np.eye(4)
        yaw = 0.05 * idx
        c, s = np.cos(yaw), np.sin(yaw)
        t_lidar[:2, :2] = [[c, -s], [s, c]]
        t_lidar[0, 3] = spacing * idx
        t_lidar[1, 3] = 0.3 * np.sin(idx)
        t_cam = a_inv @ t_lidar @ kitti.CAM_WRT_LIDAR
        cam_rows.append(" ".join(f"{v:.9e}" for v in t_cam[:3, :4].reshape(-1)))
    with open(os.path.join(root, "global_pose.txt"), "w") as f:
        f.write("\n".join(cam_rows) + "\n")
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(f"{i * 0.1:.6e}" for i in range(num_frames)) + "\n")


# --- the native-oracle comparison: the port's copy of -------------------------
# --- tests/native_oracle.compare_kitti_artifacts ----------------------------


def compare_kitti_artifacts(lib, tree: str, params, indices) -> list[str]:
    """Byte-diff what a batch_multi_bev_gen run wrote under ``tree`` (the
    multi-BEV .bin, the single-BEV CSV, the non-ground PCD's labels) against
    the native oracle ``lib`` (``oracle.load()``) run on the same input
    keyframes.  Returns report lines, "BYTES-OK <what>" / "BYTES-DIFF <what>"."""
    from pctpu_torch.experiments import oracle
    from pctpu_torch.io.pcd import read_pcd

    report = []
    for i in indices:
        data, _ = read_pcd(os.path.join(tree, "keyframe_point_cloud", f"{i:06d}.pcd"))
        labels, multi, single = oracle.preprocess(lib, data, params)
        with open(os.path.join(tree, "output_multi_bev", "binary", f"{i:06d}.bin"), "rb") as f:
            ok = np.array_equal(np.frombuffer(f.read(), np.uint8), multi.reshape(-1))
        report.append(("BYTES-OK " if ok else "BYTES-DIFF ") + f"native/multi_bev/{i:06d}.bin")
        with open(os.path.join(tree, "output_single_bev", "csv", f"{i:06d}.csv")) as f:
            csv_text = f.read()
        csv_mat = np.array([[int(v) for v in r.split(",")]
                            for r in csv_text.strip().split("\n")], np.uint8)
        ok = np.array_equal(csv_mat, single)
        report.append(("BYTES-OK " if ok else "BYTES-DIFF ") + f"native/single_bev/{i:06d}.csv")
        ng, _ = read_pcd(os.path.join(tree, "non_ground_point_cloud", f"{i:06d}.pcd"))
        ok = np.array_equal(ng["label"].astype(np.int32), labels)
        report.append(("BYTES-OK " if ok else "BYTES-DIFF ") + f"native/labels/{i:06d}.pcd")
    return report


# --- the reference build ------------------------------------------------------


def check_deps() -> list[str]:
    """The build prerequisites that are missing (empty: buildable).  PCL,
    OpenCV and Boost are found by cmake's config packages, so a tiny
    configure probes them.  Without cmake nothing is probed (pctpu's script
    runs the probe anyway and raises FileNotFoundError there)."""
    if shutil.which("cmake") is None:
        return ["cmake"]
    missing = []
    probe = tempfile.mkdtemp(prefix="parity_probe_")
    try:
        with open(os.path.join(probe, "CMakeLists.txt"), "w") as f:
            f.write(
                "cmake_minimum_required(VERSION 3.10)\nproject(probe)\n"
                "find_package(PCL REQUIRED COMPONENTS common io)\n"
                "find_package(OpenCV REQUIRED)\n"
                "find_package(Boost REQUIRED COMPONENTS program_options)\n"
            )
        r = subprocess.run(["cmake", "-S", probe, "-B", os.path.join(probe, "b")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            for dep in ("PCL", "OpenCV", "Boost"):
                if dep.lower() in (r.stderr + r.stdout).lower():
                    missing.append(dep)
            if not missing:
                missing.append(f"cmake configure failed: {r.stderr[-400:]}")
    finally:
        shutil.rmtree(probe, ignore_errors=True)
    return missing


def install_prereqs() -> bool:
    """``--build-reference``: install the pinned apt manifest
    (``scripts/reference_deps/apt-packages.txt``).  Needs root and a working
    apt; True when the install succeeded."""
    manifest = REPO / "scripts" / "reference_deps" / "apt-packages.txt"
    pkgs = [line.strip() for line in open(manifest)
            if line.strip() and not line.startswith("#")]
    if shutil.which("apt-get") is None:
        log("apt-get not available — use scripts/reference_deps/Dockerfile or install "
            "equivalents of: " + " ".join(pkgs))
        return False
    for cmd in (["apt-get", "update"], ["apt-get", "install", "-y", *pkgs]):
        log("run: " + " ".join(cmd))
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            log(f"prerequisite install FAILED ({cmd[1]}):\n{r.stderr[-800:]}")
            return False
    return True


def build_reference(workdir: str, reference: str) -> dict[str, str] | None:
    """Configure and build the reference out of tree; tool name → path."""
    # the reference vendors BackwardCpp and fmt as git submodules
    # (CMakeLists.txt:30-31): an unfetched checkout fails mid-configure
    for sub in ("ThirdParties/BackwardCpp", "ThirdParties/fmt"):
        if not os.path.exists(os.path.join(reference, sub, "CMakeLists.txt")):
            log(f"reference submodule {sub} is not initialized — run\n"
                f"  git -C {reference} submodule update --init\nand retry")
            return None
    build = os.path.join(workdir, "build")
    r = subprocess.run(["cmake", "-S", reference, "-B", build, "-DCMAKE_BUILD_TYPE=Release"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        log(f"reference cmake configure FAILED:\n{r.stderr[-2000:]}")
        return None
    r = subprocess.run(["cmake", "--build", build, "-j", str(os.cpu_count() or 2)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        log(f"reference build FAILED:\n{r.stderr[-2000:]}")
        return None
    tools = {}
    for t in REFERENCE_TOOLS:
        for root, _, files in os.walk(build):
            if t in files:
                tools[t] = os.path.join(root, t)
                break
    return tools


def run(cmd: list, **kw) -> subprocess.CompletedProcess:
    log("run: " + " ".join(map(str, cmd)))
    return subprocess.run(list(map(str, cmd)), check=True, capture_output=True, text=True, **kw)


def port_cli(tool: str, *args, device: str) -> None:
    """``python -m pctpu_torch.cli.<tool> args`` from the checkout, with
    ``--device`` where the tool takes one."""
    argv = [sys.executable, "-m", f"pctpu_torch.cli.{tool}", *map(str, args)]
    if tool in DEVICE_TOOLS:
        argv.append(f"--device={device}")
    log("run: " + " ".join(argv[1:]))
    r = subprocess.run(argv, cwd=REPO, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"pctpu_torch {tool} failed:\n{r.stderr[-2000:]}")


# --- the comparisons ------------------------------------------------------------


def _read_fmt_csv(path: str) -> np.ndarray:
    """An OpenCV FMT_CSV matrix (', '-separated, one row a line) as f64."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(tok) for tok in line.split(",")])
    return np.asarray(rows, np.float64)


def diff_trees(ref_dir: str, got_dir: str, label: str, report: list[str]) -> None:
    """Byte-compare every file under ``ref_dir`` with ``got_dir``; PNG and
    CSV BEVs that differ get a pixel-level diff for the acceptance window."""
    from pctpu_torch.io.png import read_gray_png

    for root, _, files in os.walk(ref_dir):
        for f in sorted(files):
            rp = os.path.join(root, f)
            rel = os.path.relpath(rp, ref_dir)
            gp = os.path.join(got_dir, rel)
            if not os.path.exists(gp):
                report.append(f"MISSING  {label}/{rel}")
                continue
            if filecmp.cmp(rp, gp, shallow=False):
                report.append(f"BYTES-OK {label}/{rel}")
                continue
            if f.endswith((".png", ".csv")):
                # a byte diff may be a within-window value difference (the
                # %.4g of a divergent height): compare the values
                try:
                    if f.endswith(".png"):
                        a = read_gray_png(rp).astype(int)
                        b = read_gray_png(gp).astype(int)
                    else:
                        a, b = _read_fmt_csv(rp), _read_fmt_csv(gp)
                    if a.shape != b.shape:
                        report.append(f"PX-ERR   {label}/{rel}: shapes {a.shape} vs {b.shape}")
                        continue
                    d = np.abs(a - b)
                    status = ("PX-OK" if d.max() == 0
                              else f"PX-DIFF max={d.max():.4g} n={(d > 0).sum()}")
                    report.append(f"{status} {label}/{rel}")
                except Exception as exc:  # a decoding mismatch is a finding
                    report.append(f"PX-ERR   {label}/{rel}: {exc}")
                continue
            report.append(f"BYTES-DIFF {label}/{rel}")


def parity_registration(ref_report: str, got_report: str, report: list[str]) -> None:
    """Compare icp_precision_report rows: the reference records fine-vs-coarse
    (Δxy, Δyaw) a successful pair (BatchTopPartRegistration.cpp:512-527);
    parity is both stacks inside the acceptance window."""
    def rows(path):
        out = []
        for lineno, line in enumerate(open(path), 1):
            tok = line.split()
            if not tok:
                continue
            try:
                out.append((float(tok[0]), float(tok[1])))
            except (IndexError, ValueError):
                report.append(f"REG-PARSE-ERR {os.path.basename(path)}:{lineno}: "
                              f"{line.strip()!r} (want 'diff_xy diff_yaw')")
                return None
        return out

    ra, rb = rows(ref_report), rows(got_report)
    if ra is None or rb is None:
        return
    if len(ra) != len(rb):
        report.append(f"REG-DIFF row count {len(ra)} vs {len(rb)} (success sets differ)")
        return
    worst_xy = max((abs(x1 - x2) for (x1, _), (x2, _) in zip(ra, rb)), default=0.0)
    worst_yaw = max((abs(y1 - y2) for (_, y1), (_, y2) in zip(ra, rb)), default=0.0)
    # Δxy in metres against the BEV resolution (1 px = 1 m at 224² / ±112 m)
    status = "REG-OK" if worst_yaw <= ACCEPT_YAW_DEG and worst_xy <= ACCEPT_PX else "REG-FAIL"
    report.append(f"{status} max |Δyaw(ref) − Δyaw(port)| = {worst_yaw:.4f}°, "
                  f"max |Δxy(ref) − Δxy(port)| = {worst_xy:.4f} m")


def count_bad(report: list[str]) -> int:
    """Comparisons outside the acceptance window."""
    bad = 0
    for line in report:
        tag = line.split()[0]
        if tag in ("MISSING", "BYTES-DIFF", "PX-ERR", "REG-FAIL", "REG-PARSE-ERR", "REG-DIFF"):
            bad += 1
        elif tag == "PX-DIFF":
            try:
                bad += float(line.split("max=")[1].split()[0]) > ACCEPT_PX
            except (IndexError, ValueError):
                bad += 1
    return bad


def verdict(tier: str, report: list[str], bad: int, device: dict) -> dict:
    """The machine-readable verdict: ``write_verdict``'s keys and ``device``."""
    return {"tier": tier, "comparisons": len(report), "outside_window": bad,
            "accepted": bad == 0,
            "acceptance_window": {"bev_px": ACCEPT_PX, "yaw_deg": ACCEPT_YAW_DEG},
            "lines": report, "device": device}


def write_verdict(path: str | None, result: dict) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        log(f"verdict written: {path}")


# --- the tiers ----------------------------------------------------------------------


def native_oracle_tier(workdir: str, device: str, json_path: str | None = None,
                       cli=port_cli) -> dict:
    """The tier for machines without the reference: the port's KITTI
    selector and batch_multi_bev_gen HDL_64E over a five-frame tree on
    ``device``, run by ``cli`` (``port_cli``'s signature), every written BEV
    and label artifact byte-diffed against the native oracle.  Returns the
    verdict."""
    import torch

    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments import card, oracle

    dev = card.device_record(torch.device(device))
    try:
        lib = oracle.load()
    except (OSError, subprocess.SubprocessError) as exc:
        log(f"native oracle build unavailable ({exc}) — nothing to compare")
        result = verdict("unavailable", [], 0, dev)
        write_verdict(json_path, result)
        return result
    ds = os.path.join(workdir, "ds_native")
    make_kitti_tree(ds, num_frames=5, spacing=3.0)
    cli("kitti_point_cloud_select", ds, "2.0", device=device)
    sel = os.path.join(ds, "selected_keyframes_2.00m")
    cli("batch_multi_bev_gen", sel, "HDL_64E", device=device)
    report = compare_kitti_artifacts(lib, sel, get_sensor_params("HDL_64E"), range(5))
    print("\n===== native-oracle tier report =====")
    for line in report:
        print(line)
    bad = sum(line.startswith("BYTES-DIFF") for line in report)
    print(f"===== {len(report)} comparisons, {bad} diverging =====")
    result = verdict("native-oracle", report, bad, dev)
    write_verdict(json_path, result)
    return result


def reference_tier(workdir: str, tools: dict[str, str], device: str,
                   json_path: str | None = None) -> dict:
    """The five BASELINE.json configs through the reference and the port."""
    import torch

    from pctpu_torch.experiments import card

    report: list[str] = []
    # two copies of the dataset: both stacks wipe and create outputs in it
    ds_ref, ds_got = os.path.join(workdir, "ds_ref"), os.path.join(workdir, "ds_got")
    for d in (ds_ref, ds_got):
        make_kitti_tree(d, num_frames=8, spacing=3.0)
    sel = "selected_keyframes_2.00m"

    # config 4: kitti_point_cloud_select at 2 m
    run([tools["kitti_point_cloud_select"], ds_ref, "2.0"])
    port_cli("kitti_point_cloud_select", ds_got, "2.0", device=device)
    diff_trees(os.path.join(ds_ref, sel), os.path.join(ds_got, sel), "select", report)

    # config 3: batch_multi_bev_gen HDL_64E
    run([tools["batch_multi_bev_gen"], os.path.join(ds_ref, sel) + "/", "HDL_64E"])
    port_cli("batch_multi_bev_gen", os.path.join(ds_got, sel), "HDL_64E", device=device)
    for sub in ("output_multi_bev/binary", "output_single_bev/csv", "output_single_bev/image",
                "non_ground_point_cloud", "output_multi_bev/image"):
        diff_trees(os.path.join(ds_ref, sel, sub), os.path.join(ds_got, sel, sub), sub, report)
    same = filecmp.cmp(os.path.join(ds_ref, sel, "keyframe_label.csv"),
                       os.path.join(ds_got, sel, "keyframe_label.csv"), shallow=False)
    report.append(("BYTES-OK" if same else "BYTES-DIFF") + " keyframe_label.csv")

    # config 1: cloud_manip
    cm_ref, cm_got = os.path.join(workdir, "cm_ref"), os.path.join(workdir, "cm_got")
    os.makedirs(cm_ref)
    os.makedirs(cm_got)
    run([tools["cloud_manip"], os.path.join(ds_ref, sel, "keyframe_point_cloud", "000000.pcd"),
         "1.0", "2.0", "0.0", "30"], cwd=cm_ref)
    port_cli("cloud_manip", os.path.join(ds_got, sel, "keyframe_point_cloud", "000000.pcd"),
             "1.0", "2.0", "0.0", "30", f"--output-dir={cm_got}", device=device)
    diff_trees(cm_ref, cm_got, "cloud_manip", report)

    # config 2: batch_cloud_manip
    run([tools["batch_cloud_manip"], os.path.join(ds_ref, sel) + "/"])
    port_cli("batch_cloud_manip", os.path.join(ds_got, sel), device=device)
    diff_trees(os.path.join(ds_ref, sel, "output_bvm"), os.path.join(ds_got, sel, "output_bvm"),
               "bvm", report)

    # config 5: batch_top_part_registration
    mr = os.path.join(workdir, "match_result.txt")
    with open(mr, "w") as f:
        f.write("0 1 0.0\n1 2 0.0\n2 3 0.0\n")
    got_report = os.path.join(workdir, "icp_precision_report_port.txt")
    run([tools["batch_top_part_registration"], mr,
         os.path.join(ds_ref, sel, "non_ground_point_cloud") + "/"], cwd=cm_ref)
    port_cli("batch_top_part_registration", mr, os.path.join(ds_got, sel, "non_ground_point_cloud"),
             f"--report={got_report}", device=device)
    parity_registration(os.path.join(cm_ref, "icp_precision_report.txt"), got_report, report)

    print("\n===== parity report =====")
    for line in report:
        print(line)
    bad = count_bad(report)
    print(f"===== {len(report)} comparisons, {bad} outside the acceptance window =====")
    result = verdict("reference-verified", report, bad, card.device_record(torch.device(device)))
    write_verdict(json_path, result)
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pctpu_torch.experiments.reference_parity")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write a machine-readable verdict JSON")
    ap.add_argument("--build-reference", action="store_true",
                    help="install the pinned apt manifest (scripts/reference_deps/"
                         "apt-packages.txt) before building the reference (root + apt)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port's CLIs run (default: the card)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from pctpu_torch.experiments import card

    args = parser().parse_args(sys.argv[1:] if argv is None else argv)
    if card.tool_device(args.device, "reference_parity") is None:
        return 2
    reference = os.environ.get("PCTPU_REFERENCE")
    missing = []
    if not reference:
        log("PCTPU_REFERENCE is not set: the reference tier is skipped (set it to a "
            "checkout of the reference toolchain to build and compare against it)")
    else:
        missing = check_deps()
        if missing and args.build_reference and install_prereqs():
            missing = check_deps()
        if missing:
            log(f"reference build prerequisites missing: {missing}")
            log("on a machine with PCL/OpenCV/Boost (--build-reference with root, or "
                "scripts/reference_deps/) this harness builds the reference and "
                "compares against it")
    workdir = args.workdir or tempfile.mkdtemp(prefix="pctpu_torch_parity_")
    os.makedirs(workdir, exist_ok=True)
    try:
        if not reference or missing:
            log("falling back to the native-C++-oracle tier (native/ref_oracle.cpp)")
            result = native_oracle_tier(workdir, args.device, json_path=args.json)
        else:
            log(f"workdir: {workdir}")
            tools = build_reference(workdir, reference)
            if not tools:
                return 1
            log(f"reference tools built: {sorted(tools)}")
            result = reference_tier(workdir, tools, args.device, json_path=args.json)
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    return 1 if result["outside_window"] else 0


if __name__ == "__main__":
    sys.exit(main())
