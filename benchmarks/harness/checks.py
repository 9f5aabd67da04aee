"""How ``correct`` is decided: the window's sampled answers against the plain
reference, once the window has closed and the program's state is freed.

A cell's file (``benchmarks/cells/<cell>.json``) holds its ``limits``, one a
number compared, and, for cells judged pair by pair, ``per_pair``: the gap
over which a sampled pair counts as off.  A run is correct when every
number is at or under its limit.  ``control`` puts the control in the
program's place: the reference itself, computed in the precision below the
one the configuration states (the traffic file's ``control``).
"""

from __future__ import annotations

import json
import math

import numpy as np

from harness.cells import BENCH_DIR


def rules(cell: str) -> dict:
    """The cell's file: ``limits`` and, where it judges pairs, ``per_pair``."""
    return json.loads((BENCH_DIR / "cells" / f"{cell}.json").read_text())


def verdict(numbers: dict, lims: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) in the order of ``lims``."""
    out = {}
    ok = True
    for name, limit in lims.items():
        v = numbers.get(name)
        good = v is not None and not (isinstance(v, float) and math.isnan(v)) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out


def judge_bev(win, rules: dict, control: str | None = None) -> dict:
    """Every cloud of the sampled batches against the reference: the clouds
    whose answer equals none of the reference's, and the elements that
    differ, by output."""
    from reference import bev_chain

    cfg = win.config
    off = 0
    diff_total = dict.fromkeys(bev_chain.KEYS, 0)
    clouds = 0
    for _, arrays, host in win.sample:
        for b in range(arrays["xyz"].shape[0]):
            a = {k: v[b] for k, v in arrays.items()}
            if control == "bf16_wire":
                got = next(bev_chain.answers(bev_chain.bf16_wire(a), cfg["sensor"],
                                             cfg["ground"], cfg["multi_bev"], cfg["single_bev"]))
            else:
                got = {k: host[k][b] for k in bev_chain.KEYS}
            v = bev_chain.judge(got, a, cfg["sensor"], cfg["ground"], cfg["multi_bev"],
                                cfg["single_bev"])
            off += not v["ok"]
            for k, n in v["diff"].items():
                diff_total[k] += n
            clouds += 1
    return {"numbers": {"clouds_off": off}, "clouds_checked": clouds,
            "elements_off": diff_total}


def pairs_off(per_pair: list[dict], over: dict) -> int:
    """The pairs with any gap over its per-pair limit (``over``), or not a
    number."""
    return sum(any(not g[k] <= limit for k, limit in over.items()) for g in per_pair)


def judge_registration(win, rules: dict, control: str | None = None) -> dict:
    """Every sampled pair against the reference: the translation and
    rotation gaps of its transforms and the gap of its fitness, stage by
    stage.  Compared: the pairs off (any gap over ``rules["per_pair"]``) and
    each gap's median over the pairs."""
    import torch

    from reference import registration_chain as ref

    dev = win.device
    tf32 = torch.backends.cuda.matmul.allow_tf32
    run = ref.top_part_pair if win.stage == "top_part" else ref.whole_pair
    per_pair = []
    try:
        for p, best, fine in win.sample:
            q = ref.cloud(win.frames[p.q], p.scale_q, dev)
            m = ref.cloud(win.frames[p.m], p.scale_m, dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            want = run(q, m, p.guess_deg, win.config, dev)
            if control == "tf32":
                # the control's answers in the program's place
                torch.backends.cuda.matmul.allow_tf32 = True
                ctl = run(q, m, p.guess_deg, win.config, dev)
                got = {k: (v[1], v[2].cpu().numpy()) for k, v in ctl.items()}
            else:
                got = {"fine": (float(fine.fitness), np.asarray(fine.transform))}
                if best is not None:
                    got["coarse"] = (float(best.fitness), np.asarray(best.transform))
            per_pair.append(ref.gaps(got, want))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # a pair whose ICP stops one iteration apart on the two sides can lie
    # centimetres off on a sound run, so a few pairs off are allowed, and
    # the median pair's gaps are compared beside the count
    keys = list(per_pair[0]) if per_pair else []
    numbers = {"pairs_off": pairs_off(per_pair, rules["per_pair"])}
    numbers.update({f"{k}.median": float(np.median([g[k] for g in per_pair])) for k in keys})
    widest = {f"{k}.max": float(np.max([g[k] for g in per_pair])) for k in keys}
    return {"numbers": numbers, "pairs_checked": len(win.sample), "widest": widest,
            "per_pair": per_pair}
