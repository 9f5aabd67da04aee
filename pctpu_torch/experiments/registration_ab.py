"""Pairs/s of the two registration CLIs, one checkout against another, on
one CUDA card.

    python3 -m pctpu_torch.experiments.registration_ab CHECKOUT_A CHECKOUT_B [--rounds=N]
        [--pair-batch=N] [--match=match_result_20.txt]

Builds the registration tree of ``chip_smoke.py``'s phases 5-6 and 10
(``experiments.scene.registration_tree``: the bench scene and three moved
copies with 1 cm noise, yaws 17°, −25° and 178°; five pairs with yaw guesses
2-4° off in ``match_result.txt``, twenty in ``match_result_20.txt``) under
``build/``, then runs each checkout's
``batch_top_part_registration`` and ``batch_whole_registration`` CLIs on it,
each checkout in a process of its own with its own kernels, in the order A,
B, B, A (``--rounds`` times).  A
process runs one warm-up pair per CLI, then the match list three times per
CLI, and prints one JSON line per run: pairs/s (host clock around the CLI,
ending in a synchronize), the ``[TIME]`` ms per pair, whether every pair
succeeded, and the card's name and power limit.  ``--pair-batch=N`` passes
that flag to both CLIs of both checkouts (and adds ``pair_batch`` to the
lines); ``--match`` picks the tree's match list (default
``match_result.txt``, the five pairs).  Without them the CLIs get the
arguments and the lines the keys they always had.
"""

from __future__ import annotations

import os
import subprocess
import sys

# one checkout's measurement, run with that checkout as the working
# directory so that ``pctpu_torch`` is its package
_RUN = r"""
import contextlib, io, json, os, re, sys, time
import torch
from pctpu_torch.cli import batch_top_part_registration as top
from pctpu_torch.cli import batch_whole_registration as whole
from pctpu_torch.experiments.card import nvidia_smi_line

tree, tag, checkout, match_name, pair_batch = sys.argv[1:6]
clouds = os.path.join(tree, "clouds")
card = nvidia_smi_line()
n_pairs = len(open(os.path.join(tree, match_name)).read().split("\n")) - 1
extra = [f"--pair-batch={pair_batch}"] if pair_batch else []


def run(cli, match, argv):
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([match, clouds, *argv])
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0, out.getvalue()


for name, cli, argv in (("batch_top_part_registration", top,
                         ["--capacity=65536", "--flat-cap=32768", *extra]),
                        ("batch_whole_registration", whole, ["--capacity=65536", *extra])):
    def report(k):
        return [f"--report={os.path.join(tree, f'{tag}_{name}_{k}.txt')}"]

    run(cli, os.path.join(tree, "warmup.txt"), argv + report("warm"))
    for k in range(3):
        rc, wall, log = run(cli, os.path.join(tree, match_name), argv + report(k))
        times = re.findall(r"\[TIME\] Avg Tiempo for \S+ Stage \((\w+)\): ([0-9.eE+-]+)", log)
        line = {"tag": tag, "checkout": checkout, "cli": name, "run": k,
                "ok": rc == 0 and "count_failure: 0," in log,
                "pairs_per_s": n_pairs / wall,
                "time_ms_per_pair": {s: float(v) for s, v in times},
                "card": card}
        print(json.dumps({**line, **({"pair_batch": int(pair_batch)} if pair_batch else {})}),
              flush=True)
"""


def main(argv: list[str] | None = None) -> int:
    import shutil

    import torch

    from pctpu_torch.experiments.scene import registration_tree

    argv = sys.argv[1:] if argv is None else argv

    def flag(name, default):
        return next((a.split("=", 1)[1] for a in argv if a.startswith(f"--{name}=")), default)

    rounds = int(flag("rounds", 1))
    pair_batch = flag("pair-batch", "")
    match_name = flag("match", "match_result.txt")
    checkouts = [os.path.abspath(a) for a in argv if not a.startswith("--")]
    if len(checkouts) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("registration_ab needs a CUDA card")
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "registration_ab")
    shutil.rmtree(root, ignore_errors=True)
    registration_tree(root)
    order = ["A", "B", "B", "A"] * rounds
    for tag in order:
        checkout = checkouts[0] if tag == "A" else checkouts[1]
        res = subprocess.run([sys.executable, "-c", _RUN, root, tag, checkout, match_name,
                              pair_batch],
                             cwd=checkout, env={**os.environ, "PYTHONPATH": checkout},
                             capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
    shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
