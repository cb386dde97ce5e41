"""The plain reference at tiny sizes: its nearest hits against a float64
brute force, and its loss and gradients against itself in float64."""

import numpy as np
import pytest
import torch

from perfbench.inputs.scenes import city_scene, rough_terrain
from perfbench.reference.traverse import moller_trumbore, tree_for


def brute(v, f, o, d, t_max):
    tri = v[f.long()].double()
    v0 = tri[:, 0]
    t, ok = moller_trumbore(o.double()[:, None], d.double()[:, None],
                            v0[None], (tri[:, 1] - v0)[None],
                            (tri[:, 2] - v0)[None])
    t = torch.where(ok & (t <= t_max), t, torch.full_like(t, 1e300))
    return t


@pytest.mark.parametrize("kind", ["city", "terrain"])
def test_nearest_hits_match_a_float64_brute_force(kind):
    rng = np.random.default_rng(5)
    g = torch.Generator().manual_seed(5)
    N = 3000
    if kind == "city":
        s = city_scene(rng, 60)
        o = torch.zeros(N, 3)
        o[:, 1] = 2.0
        o[:, [0, 2]] = torch.rand(N, 2, generator=g) * 40 - 20
        d = torch.randn(N, 3, generator=g)
    else:
        s = rough_terrain(rng, 8000, half=50.0)
        o = torch.rand(N, 3, generator=g) * 80 - 40
        o[:, 1] = 30.0
        d = torch.randn(N, 3, generator=g) * 0.3
        d[:, 1] = -1.0
    d = d / d.norm(dim=1, keepdim=True)
    v, f = torch.from_numpy(s["vertices"]), torch.from_numpy(s["faces"])
    t, face = tree_for(v, f).nearest_hits(o, d, 60.0, ray_block=512,
                                           pair_block=4096)
    tt = brute(v, f, o, d, 60.0)
    best, _ = tt.min(1)
    hit = best < 1e300
    assert hit.float().mean() > 0.5
    assert torch.equal(face >= 0, hit)
    rows = torch.arange(N)[hit]
    # the chosen face is a nearest one (ties between faces at the same t)
    assert (tt[rows, face[hit]] - best[hit]).abs().max() < 1e-4
    assert (t[hit].double() - best[hit]).abs().max() < 1e-4


def test_float32_loss_and_gradients_agree_with_float64(tiny_spec):
    from perfbench.drivers import fit
    spec = tiny_spec("alphaprime_city.fit")
    inp = fit.inputs(spec["config"], 3)
    r32 = fit.reference(inp, inp["rays"], spec["traffic"], "cpu")
    r64 = fit.reference(inp, inp["rays"], spec["traffic"], "cpu",
                        dtype=torch.float64)
    assert r32["returns"] == r64["returns"] > 0
    assert r32["loss"] == pytest.approx(r64["loss"], rel=1e-5)
    for k in r64["grad_norm"]:
        assert r32["grad_norm"][k] == pytest.approx(r64["grad_norm"][k],
                                                    rel=1e-4)


@pytest.mark.parametrize("cell", ["alphaprime_city.fit", "als_terrain.fit"])
def test_hit_diagnostic_finds_the_program_and_the_reference_agree(
        cell, tiny_spec):
    import hitdiff
    out = hitdiff.compare(tiny_spec(cell), 3, "cpu")
    assert out["rays"] > 0 and out["reference_only"] == 0
    assert out["differ"] == out["ties"] + out["program_only"]
