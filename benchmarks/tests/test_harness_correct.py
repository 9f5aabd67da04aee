"""How ``correct`` is decided: a sound run on the CPU is correct, and with
the timed path broken underneath (each fault a cell can have) or the
control in the program's place it is not.  The cells run on one card, so
no exchange between cards can be left out."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import small_run

BEV = ["mulran-os1-64.bev"]
REG = ["kitti-hdl64e.toppart64", "kitti-hdl64e.whole64"]


@pytest.mark.parametrize("cell", BEV + REG)
def test_sound_run_is_correct(cell, monkeypatch):
    code, result = small_run(cell, monkeypatch)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


# --- the BEV loop body broken underneath -------------------------------------------


def _bev_fault(kind, monkeypatch):
    from pctpu_torch.ops import preprocess
    from pctpu_torch.pipelines import multi_bev

    real = preprocess.preprocess_batch
    real_wire = multi_bev._wire

    def unchanged(clouds, params, *a, **k):
        # the step hands back its input: nothing ordered, marked or drawn
        _, multi, single = real(clouds, params, *a, **k)
        return clouds, torch.zeros_like(multi), torch.zeros_like(single)

    def half(clouds, params, *a, **k):
        # the batch's second half never computed: the first half's answers
        b = clouds.xyz.shape[0]
        lab, multi, single = real(clouds, params, *a, **k)
        h = b // 2

        def dup(x):
            return torch.cat([x[:b - h], x[:h]])
        return (lab.replace(**{f: dup(getattr(lab, f)) for f in
                               ("xyz", "intensity", "row", "col", "t", "label")}),
                dup(multi), dup(single))

    def altered(labeled):
        # one answer of each batch altered where it is made
        out = real_wire(labeled)
        label = out["label"].clone()
        label[0, 100] += 1
        return {**out, "label": label}

    if kind == "altered":
        monkeypatch.setattr(multi_bev, "_wire", altered)
    else:
        monkeypatch.setattr(preprocess, "preprocess_batch",
                            {"unchanged": unchanged, "half": half}[kind])


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", BEV)
def test_bev_fault_is_not_correct(cell, kind, monkeypatch):
    _bev_fault(kind, monkeypatch)
    code, result = small_run(cell, monkeypatch)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", BEV)
def test_bev_control_is_not_correct(cell, monkeypatch):
    """The control: the reference with the keyframes' xyz narrowed to
    bfloat16 on the wire, in the program's place."""
    from harness import checks, main

    seen = {}
    monkeypatch.setattr(main, "make_window", _keep(main.make_window, seen))
    small_run(cell, monkeypatch)
    got = seen["win"].check(checks.rules(cell), "bf16_wire")
    ok, _ = checks.verdict(got["numbers"], checks.rules(cell)["limits"])
    assert not ok


def _keep(make, seen):
    def wrapped(*a, **k):
        seen["win"] = make(*a, **k)
        return seen["win"]
    return wrapped


# --- the registration drivers broken underneath ----------------------------------------


def _reg_fault(kind, monkeypatch):
    from pctpu_torch.ops.icp import IcpResult
    from pctpu_torch.pipelines import registration as R

    real_icp = R.icp_batched
    real_fetch = R._fetch_pair_results
    real_whole = R.register_whole_pairs

    def unchanged(src, src_mask, tgt, tgt_mask, guess, cfg, *a, **k):
        # the ICP hands back its state unchanged: the guess
        res = real_icp(src, src_mask, tgt, tgt_mask, guess, cfg, *a, **k)
        return IcpResult(res.converged, res.fitness, guess.to(res.transform.dtype))

    def half_of(results):
        n = len(results)
        h = n // 2
        return results[:n - h] + results[:h]

    def altered_of(results):
        out = []
        for best, fine in results:
            t = np.array(fine.transform, copy=True)
            t[0, 3] += 0.05
            out.append((best, IcpResult(fine.converged, fine.fitness, t)))
        return out

    if kind == "unchanged":
        monkeypatch.setattr(R, "icp_batched", unchanged)
        return
    wrap = {"half": half_of, "altered": altered_of}[kind]
    monkeypatch.setattr(R, "_fetch_pair_results",
                        lambda *a, **k: wrap(real_fetch(*a, **k)))
    monkeypatch.setattr(R, "register_whole_pairs",
                        lambda *a, **k: [f for _, f in wrap([(None, f) for f in
                                                             real_whole(*a, **k)])])


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", REG)
def test_registration_fault_is_not_correct(cell, kind, monkeypatch):
    _reg_fault(kind, monkeypatch)
    code, result = small_run(cell, monkeypatch)
    assert not result["correct"], result["checks"]


def _reference_program(monkeypatch, config):
    """The registration drivers answered pair by pair by the plain reference:
    a sound stand-in for the program that runs on the CPU at a cell's own
    pair batch, so that a fault can be planted over it at that size."""
    from pctpu_torch.ops.icp import IcpResult
    from pctpu_torch.pipelines import registration as R
    from reference import registration_chain as ref

    def answer(c1, c2, guess, tool):
        got = tool(*((c.xyz[:c.count], c.label[:c.count]) for c in (c1, c2)), guess, config,
                   c1.xyz.device)
        return {k: IcpResult(np.bool_(v[0]), np.float32(v[1]), v[2].cpu().numpy())
                for k, v in got.items()}

    def pipelined(loaders, cfg, flat_cap=32768, depth=1, **k):
        for load in loaders:
            yield [(a["coarse"], a["fine"]) for a in
                   (answer(*pair, ref.top_part_pair) for pair in load())]

    def whole(pairs, cfg, *a, **k):
        return [answer(*pair, ref.whole_pair)["fine"] for pair in pairs]

    monkeypatch.setattr(R, "register_pairs_pipelined", pipelined)
    monkeypatch.setattr(R, "register_whole_pairs", whole)


def _own_size_run(cell, monkeypatch, half: bool):
    """One batch of the cell's own traffic (pair batch, places, sampled
    pairs) over the reference stand-in, with or without the second half of
    each batch given the first half's answers."""
    from harness import cells
    from pctpu_torch.pipelines import registration as R

    _reference_program(monkeypatch, cells.resolve(cell).config)
    if half:
        def half_of(results):
            h = len(results) // 2
            return results[:len(results) - h] + results[:h]

        stand_in, stand_in_whole = R.register_pairs_pipelined, R.register_whole_pairs
        monkeypatch.setattr(R, "register_pairs_pipelined",
                            lambda *a, **k: (half_of(b) for b in stand_in(*a, **k)))
        monkeypatch.setattr(R, "register_whole_pairs",
                            lambda *a, **k: half_of(stand_in_whole(*a, **k)))
    code, result = small_run(cell, monkeypatch, seconds=0.0, traffic={"warmup_batches": 0},
                             thin=64)
    traffic = cells.resolve(cell).traffic
    assert result["attempted"] == traffic["pair_batch"]
    return result


@pytest.mark.parametrize("cell", REG)
def test_reference_stand_in_is_correct_at_the_cells_size(cell, monkeypatch):
    result = _own_size_run(cell, monkeypatch, half=False)
    assert result["correct"], result["checks"]
    assert result["checks"]["pairs_off"]["value"] == 0


@pytest.mark.parametrize("cell", REG)
def test_registration_half_fault_at_the_cells_size(cell, monkeypatch):
    """Half the batch left out at the cell's own pair batch and sampled
    pairs: pairs 33-64 of every batch carry pairs 1-32's answers."""
    result = _own_size_run(cell, monkeypatch, half=True)
    assert not result["correct"], result["checks"]
    assert result["checks"]["pairs_off"]["value"] > result["checks"]["pairs_off"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", REG)
def test_registration_control_is_not_correct(cell, card, monkeypatch):
    """The control: the reference with TF32 products, in the program's place
    (on the card: TF32 has no CPU form)."""
    from harness import checks, main

    seen = {}
    monkeypatch.setattr(main, "make_window", _keep(main.make_window, seen))
    small_run(cell, monkeypatch)
    win = seen["win"]
    win.device = card
    got = win.check(checks.rules(cell), "tf32")
    ok, _ = checks.verdict(got["numbers"], checks.rules(cell)["limits"])
    assert not ok
