"""The two-stage registration differential in the port: pctpu_torch's
``register_pair`` and ``register_whole_pairs`` (on the CPU) against the
composed plain-loop oracles ``ref_impl.two_stage_ref`` / ``whole_ref`` and
against pctpu's own drivers, on ``twostage_scene`` inputs — the glue no
per-stage test holds: stage wiring, the f32 guess chain, the best-of-two,
fine seeding and the success classification.

The contract is the port's copy in ``experiments.fuzz_campaign``
(``two_stage_contract``, ``whole_contract``): pctpu's
``assert_two_stage_matches`` with the report's yaw delta compared modulo
360° and the classification held on anchored or same-basin scenes only
(D19).  A scene is held to the oracle only where the oracle's outcome is
stable under a 1e-6 shift of the source and its trajectories are well
posed (pctpu's filter).  The oracle is ``tests/ref_impl.py`` itself, its
1-NN loop run by the C transcription that ``oracle.ref_impl`` swaps in
(``tests/test_torch_fuzz_campaign.py`` holds it equal to the loop).

Seeds: pctpu's pinned two-stage seeds (``test_twostage_differential.py:347``)
and its whole-driver seeds (``:322``).  On the CPU at capacity 2,048 a
pair's results do not hang on its batch (README D5), so the batch of 16 is
held bit-equal to the pairs run one by one."""

import math

import numpy as np
import pytest
import torch

from pctpu.cloud import make_cloud as jmake_cloud
from pctpu.config import WHOLE_ICP as J_WHOLE_ICP
from pctpu.config import RegistrationConfig as JRegistrationConfig
from pctpu.pipelines.registration import register_pair as jregister_pair
from pctpu.pipelines.registration import register_whole_pairs as jregister_whole_pairs
from pctpu_torch.experiments import fuzz_campaign as fc
from pctpu_torch.experiments import fuzz_scenes as fs
from pctpu_torch.experiments import oracle

from . import test_twostage_differential as jtest

SEEDS = [0, 1, 2, 3, 4, 1200029, 1200196, 1200241]
WHOLE_SEEDS = [0, 1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: several xdist workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pctpu_pair(scene):
    xyz1, lab1, xyz2, lab2, guess = scene[:5]
    c1 = jmake_cloud(xyz1, label=lab1, capacity=2048)
    c2 = jmake_cloud(xyz2, label=lab2, capacity=2048)
    return jregister_pair(c1, c2, angle_guess_deg=guess, flat_cap=2048)


def _pctpu_whole(scene):
    xyz1, lab1, xyz2, lab2, guess = scene[:5]
    c1 = jmake_cloud(xyz1, label=lab1, capacity=2048)
    c2 = jmake_cloud(xyz2, label=lab2, capacity=2048)
    (fine,) = jregister_whole_pairs([(c1, c2, guess)], JRegistrationConfig(fine=J_WHOLE_ICP))
    return fine


def assert_matches_pctpu(port, jres, ref):
    """The port against pctpu on one scene: the same classification where
    the basins agree (D19), and on scenes the oracle anchors coarse
    transforms within 0.03 and fine within 5e-3 (D5: the two stacks sum in
    other orders).  Returns D19's evidence of a basin split, or None."""
    note = fc.same_classification(port, jres, ref, "port vs pctpu")
    if ref["best"]["fitness"] < fc.ANCHORED_FITNESS:
        np.testing.assert_allclose(port[0].transform, np.asarray(jres[0].transform), atol=0.03,
                                   rtol=0)
        assert bool(port[1].converged) == bool(jres[1].converged)
    return note


@pytest.mark.parametrize("seed", SEEDS)
def test_scene_is_pctpu_s(seed):
    """The port's scene copy draws pctpu's scene from the seed."""
    for a, b in zip(fs.twostage_scene(seed), jtest.twostage_scene(seed)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b or (math.isnan(a) and math.isnan(b))


def test_pinned_seeds_as_one_batch_of_16():
    """The pinned scenes twice over as one ``register_pairs`` batch of 16
    (as ``--pair-batch=16`` runs them): each pair bit-equal to its run
    alone, and both copies of a scene bit-equal to each other."""
    scenes = [fs.twostage_scene(s) for s in SEEDS] * 2
    batched = fc.run_pairs_batched(scenes, CPU)
    assert len(batched) == 16
    for k, scene in enumerate(scenes[:len(SEEDS)]):
        single = fc.run_pair(scene, CPU)
        for got in (batched[k], batched[k + len(SEEDS)]):
            for a, b in zip(got, single):
                np.testing.assert_array_equal(a.transform, b.transform, err_msg=str(SEEDS[k]))
                assert float(a.fitness) == float(b.fitness)
                assert bool(a.converged) == bool(b.converged)


@pytest.mark.parametrize("seed", SEEDS)
def test_two_stage_matches_composed_oracle(seed):
    """``register_pair`` against the composed oracle and pctpu's on a
    pinned seed (every pinned seed's oracle is stable, so each is held):
    the contract, no basin split but on 1200029 (pctpu's D19 seed), and a
    success within 0.5° of the true yaw."""
    scene = fs.twostage_scene(seed)
    ref, stable = fc.twostage_oracle_stable(oracle.ref_impl(), *scene[:5])
    assert stable, "the pinned scene's oracle is no longer stable"
    port = fc.run_pair(scene, CPU)
    notes = fc.two_stage_contract(*port, ref)
    jres = _pctpu_pair(scene)
    assert_matches_pctpu(port, jres, ref)
    # pctpu's result meets the port's contract too
    fc.two_stage_contract(*jres, ref)
    if seed != 1200029:
        assert not notes, notes
    true_yaw = scene[5]
    if ref["success"] and not math.isnan(true_yaw):
        yaw = math.degrees(math.atan2(port[1].transform[1, 0], port[1].transform[0, 0]))
        assert fc.yaw_delta(yaw, true_yaw) < 0.5


@pytest.mark.parametrize("seed", WHOLE_SEEDS)
def test_whole_registration_matches_composed_oracle(seed):
    """``register_whole_pairs`` against ``whole_ref`` and pctpu's driver."""
    scene = fs.twostage_scene(seed)
    ref, stable = fc.whole_oracle_stable(oracle.ref_impl(), *scene[:5])
    assert stable, "the whole-driver scene's oracle is no longer stable"
    (fine,) = fc.run_whole([scene], CPU)
    fc.whole_contract(fine, ref)
    jfine = _pctpu_whole(scene)
    fc.whole_contract(jfine, ref)
    assert (float(fine.fitness) <= 1.5) == (float(jfine.fitness) <= 1.5) == ref["success"]
    if ref["fine"]["fitness"] < fc.ANCHORED_FITNESS:
        np.testing.assert_allclose(fine.transform, np.asarray(jfine.transform), atol=5e-3, rtol=0)


@pytest.mark.slow
def test_batch_of_16_matches_composed_oracle():
    """The batch of 16 against the oracle, scene by scene, and the whole
    driver's seeds as one ``register_whole_pairs`` batch."""
    ref_impl = oracle.ref_impl()
    scenes = [fs.twostage_scene(s) for s in SEEDS] * 2
    refs = [fc.twostage_oracle_stable(ref_impl, *s[:5])[0] for s in scenes[:len(SEEDS)]] * 2
    for res, ref in zip(fc.run_pairs_batched(scenes, CPU), refs):
        fc.two_stage_contract(*res, ref)
    whole = [fs.twostage_scene(s) for s in WHOLE_SEEDS]
    for fine, scene in zip(fc.run_whole(whole, CPU), whole):
        fc.whole_contract(fine, fc.whole_oracle_stable(ref_impl, *scene[:5])[0])


def test_yaw_delta_wraps():
    """ADVICE's second fix: report yaws either side of ±180° are close."""
    assert fc.yaw_delta(179.99, -179.99) == pytest.approx(0.02, abs=1e-9)
    assert fc.yaw_delta(-179.5, 179.7) == pytest.approx(0.8, abs=1e-9)
    assert fc.yaw_delta(10.0, 10.0) == 0.0


def test_classification_not_held_across_basins():
    """ADVICE's first fix: on a degenerate scene whose coarse winner left
    the oracle's basin, fitness values are not comparable (D19), so a
    different classification is reported as D19 evidence, not asserted;
    in the oracle's basin it is asserted."""
    ident = np.eye(4, dtype=np.float32)
    far = ident.copy()
    far[0, 3] = 5.0

    class R:
        def __init__(self, t, fitness):
            self.transform, self.fitness, self.converged = t, np.float32(fitness), True

    ref = {"best": {"fitness": 300.0, "transform": ident}, "best_i": 0,
           "coarse": [{"transform": ident, "fitness": 300.0},
                      {"transform": far * 3, "fitness": 400.0}],
           "fine": {"fitness": 1.0, "transform": ident, "converged": True}, "success": True}
    notes = fc.two_stage_contract(R(far, 310.0), R(far, 9.0), ref)
    assert notes and "basin split" in notes[0]
    failed = dict(ref, fine={"fitness": 2.0, "transform": ident, "converged": True},
                  success=False)
    with pytest.raises(AssertionError, match="classification"):
        fc.two_stage_contract(R(ident, 310.0), R(ident, 1.2), failed)
