"""pctpu's pinned neighbour-selection knife edges (README D3;
``tests/test_normals_knife_edge.py``) through the port's ``normals_2d`` /
``normals_2d_knn`` on the CPU.

A point whose exact d² to a candidate lies within the expanded-form
score's rounding window of the decision boundary (the radius r², or the
k-th neighbour's distance) may take either neighbour set, and the two sets
give normals far apart.  Whichever side the port lands on, its normal must
equal the plain oracle's on one of the sets the window allows; its
validity must equal the oracle's and pctpu's, and the scene must still
carry the documented ambiguity."""

import numpy as np
import pytest
import torch

from pctpu.ops.normals2d import normals_2d as jnormals_2d
from pctpu.ops.normals2d import normals_2d_knn as jnormals_2d_knn
from pctpu_torch.experiments import fuzz_scenes as fs
from pctpu_torch.ops.normals2d import normals_2d, normals_2d_knn

from . import ref_impl
from .test_normals_knife_edge import CASES, _win


@pytest.mark.parametrize("seed,i,mode,candidates", CASES)
def test_scene_carries_the_documented_ambiguity(seed, i, mode, candidates):
    """The port's copy of the scene has the pinned point's boundary
    candidates inside the D3 window, and alternative sets exist."""
    p2, _ = fs.normals_scene(seed)
    win = _win(p2)
    d2 = np.sum((p2.astype(np.float64) - p2[i].astype(np.float64)) ** 2, axis=1)
    if "radius" in mode:
        amb = np.flatnonzero(np.abs(d2 - mode["radius"] ** 2) <= win)
    else:
        boundary = d2[np.argsort(d2, kind="stable")[mode["k"] - 1]]
        amb = np.flatnonzero(np.abs(d2 - boundary) <= win)
    assert set(amb.tolist()) >= set(candidates)
    assert len(list(ref_impl.normals2d_knife_edge_sets(p2, i, win, **mode))) >= 1


@pytest.mark.parametrize("seed,i,mode,candidates", CASES)
def test_port_normal_is_in_the_knife_edge_family(seed, i, mode, candidates):
    p2, xyz = fs.normals_scene(seed)
    mask = np.ones(len(p2), bool)
    xyz_t, mask_t = torch.from_numpy(xyz), torch.from_numpy(mask)
    if "radius" in mode:
        nrm, _, ok = normals_2d(xyz_t, mask_t, radius=mode["radius"])
        _, _, jok = jnormals_2d(xyz, mask, radius=mode["radius"])
        ref_n, ref_ok = ref_impl.normals2d_ref(xyz, radius=mode["radius"])
    else:
        nrm, _, ok = normals_2d_knn(xyz_t, mask_t, mode["k"])
        _, _, jok = jnormals_2d_knn(xyz, mask, mode["k"])
        ref_n, ref_ok = ref_impl.normals2d_knn_ref(xyz, mode["k"])
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jok))
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok[i]
    ours = nrm.numpy()[i, :2]

    win = _win(p2)
    family = [ref_n[i]]
    for alt in ref_impl.normals2d_knife_edge_sets(p2, i, win, **mode):
        alt_n = ref_impl.normal2d_from_set(p2, i, alt)
        if alt_n is not None:
            family.append(alt_n)
    assert len(family) >= 2
    dists = [min(np.linalg.norm(ours - f), np.linalg.norm(ours + f)) for f in family]
    assert min(dists) < 5e-3, f"port normal {ours} outside the knife-edge family ({dists})"
