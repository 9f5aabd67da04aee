"""The fused unpruned 1-NN (``cuda_knn.nn_1_fused``, K3) apart from
``chip_smoke.py``: its grid and time over the target splits, on one CUDA
card.

    python3 -m pctpu_torch.experiments.nn_fused_probe

At 65,536² and 16,384² (uniform in ±70 m, 5% masked): the three launches of
``nn_1_fused`` with the splits the C side picks and with 1, 2, 4, ... fixed
splits, each held index for index against the twin
(``nn_1_fused_reference``, on the card), then timed by CUDA events (the C
call alone, in turns) and per kernel by torch.profiler;
the grid (query tiles × splits), the bound (8 flop a pair at the card's f32
rate) and the share of it reached.  Every line carries the card's name and
power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def main() -> int:
    from pctpu_torch.experiments.card import bound_ms, cuda_ms, nvidia_smi_line, profile_calls
    from pctpu_torch.ops import cuda_knn

    if not torch.cuda.is_available():
        raise SystemExit("nn_fused_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    rng = np.random.default_rng(3)
    for n in (65536, 16384):
        q, t = (torch.from_numpy(rng.uniform(-70, 70, (n, 3)).astype(np.float32)).to(dev)
                for _ in range(2))
        qm, tm = (torch.from_numpy(rng.random(n) >= 0.05).to(dev) for _ in range(2))
        args = (q, qm, t, tm)
        bound = bound_ms(n * (13 + 8) + n * 13, 8 * n * n)
        want = cuda_knn.nn_1_fused_reference(*args)[0]
        cases, seen = [], set()
        for splits in (0, 1, 2, 4, 8, 16, 32, 64, 128):
            grid = cuda_knn.fused_grid(n, n, splits)
            if grid in seen:
                continue
            seen.add(grid)
            launch, idx, _ = cuda_knn._fused_launcher(*args, splits=splits)
            launch()
            torch.cuda.synchronize()
            bad = int((idx != want).sum())
            if bad:
                raise AssertionError(f"Q = T = {n}, splits {splits}: {bad} indices differ "
                                     "from the twin's")
            cases.append((f"splits {'picked' if splits == 0 else 'fixed'}: grid "
                          f"{grid[0]} x {grid[1]} = {grid[0] * grid[1]} blocks", launch, grid))
        ms = {name: [] for name, *_ in cases}
        for name, launch, _ in cases + cases[::-1]:
            ms[name].append(cuda_ms(launch, reps=10))
        for name, launch, _ in cases:
            by_kernel = profile_calls(launch, reps=10)[2]
            print(f"Q = T = {n}: {name}: {min(ms[name]):.4f} ms alone (CUDA events, the least of "
                  f"two turns), bound {bound[0]:.6f} ms ({bound[1]}), reached "
                  f"{bound[0] / min(ms[name]):.4f}; device ms by kernel "
                  f"{ {k: round(v, 6) for k, v in by_kernel.items()} }; card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
