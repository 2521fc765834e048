"""The scene generator repeats per seed and follows its stated laws."""

import math

import numpy as np
import pytest
import torch

from benchmark import traffic as T
from benchmark.harness import Cell
from benchmark.reference.gmfs import gmf_cmod5n, gmf_s1_v2

CPU = torch.device("cpu")


@pytest.fixture
def cell(root):
    c = Cell(root, "s1_iw_host")
    c.traffic = dict(c.traffic, lines=150, samples=400, pool=2)
    return c


def scenes(cell, seed):
    gen = T.generator(seed, CPU)
    return [T.make_scene(cell.traffic, cell.config, gen, p, CPU)
            for p in T.scene_plan(cell.traffic, gen)]


def test_same_seed_same_scenes_other_seed_same_sizes(cell):
    a, b, c = scenes(cell, 2 ** 31 + 7), scenes(cell, 2 ** 31 + 7), scenes(cell, 11)
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys() == z.keys()
        for k in x:
            if k == "shape":
                assert x[k] == y[k] == z[k]
                continue
            assert torch.equal(x[k].nan_to_num(-1), y[k].nan_to_num(-1))
            assert x[k].shape == z[k].shape
        assert not torch.equal(x["s0_co"].nan_to_num(-1), z["s0_co"].nan_to_num(-1))


def test_every_seed_gets_the_same_set_of_mean_speeds_and_land(cell):
    traffic = dict(cell.traffic, pool=8)
    plans = [T.scene_plan(traffic, T.generator(seed, CPU)) for seed in (1, 2, 2 ** 40)]
    for key in ("speed_mean", "land"):
        sets = [sorted(p[key] for p in plan) for plan in plans]
        assert sets[0] == sets[1] == sets[2]
    assert [p["speed_mean"] for p in plans[0]] != [p["speed_mean"] for p in plans[1]]
    assert sorted(p["speed_mean"] for p in plans[0]) == pytest.approx(
        [2 + 23 * (i + 0.5) / 8 for i in range(8)])
    # every second scene has a coast, with fractions spread over [0, 0.3]
    assert [p["land"] > 0 for p in plans[0]] == [False, True] * 4
    assert sorted(p["land"] for p in plans[0] if p["land"]) == pytest.approx(
        [0.3 * (i + 0.5) / 4 for i in range(4)])


def test_incidence_ramps_along_the_samples_the_same_on_every_line(cell):
    s = scenes(cell, 3)[0]
    inc = s["inc"].reshape(s["shape"])
    lo, hi = cell.traffic["incidence_deg"]
    assert torch.equal(inc, inc[:1].expand_as(inc))
    assert inc[0, 0] == lo and inc[0, -1] == hi
    assert torch.allclose(torch.diff(inc[0]), torch.full((inc.shape[1] - 1,), (hi - lo)
                                                         / (inc.shape[1] - 1),
                                                         dtype=torch.float64))


def test_land_is_a_contiguous_coastal_block_in_every_other_scene(cell):
    for seed in (1, 2, 3, 4):
        sea, coast = scenes(cell, seed)
        assert not torch.isnan(sea["s0_co"]).any()
        lines, samples = coast["shape"]
        for k in ("s0_co", "s0_cr", "dsig_cr"):
            nan = torch.isnan(coast[k]).reshape(lines, samples)
            cols = nan.all(0)
            assert torch.equal(nan, cols.expand_as(nan))  # whole lines of columns
            width = int(cols.sum())
            assert width <= math.ceil(0.3 * samples)
            if width:
                assert bool(cols[0]) != bool(cols[-1])  # one side of the swath
                edge = torch.nonzero(torch.diff(cols.int())).numel()
                assert edge == 1  # contiguous
        assert not torch.isnan(coast["inc"]).any() and not torch.isnan(coast["anc_re"]).any()


def test_sigma0_noise_and_ancillary_errors_follow_their_laws(cell):
    s = scenes(cell, 5)[0]
    ok = ~torch.isnan(s["s0_co"])
    clean_co = gmf_cmod5n(s["inc"], s["wspd"], s["phi"])
    clean_cr = gmf_s1_v2(s["inc"], s["wspd"])
    for got, clean, sd in ((s["s0_co"], clean_co, 0.3), (s["s0_cr"], clean_cr, 0.5)):
        db = 10 * torch.log10(got[ok] / clean[ok])
        assert abs(float(db.mean())) < 0.01
        assert float(db.std()) == pytest.approx(sd, rel=0.02)
    anc_speed = torch.hypot(s["anc_re"], s["anc_im"])
    assert float((anc_speed - s["wspd"]).std()) == pytest.approx(1.5, rel=0.03)
    ddir = torch.rad2deg(torch.atan2(s["anc_im"], s["anc_re"])) - s["phi"]
    ddir = (ddir + 180) % 360 - 180
    assert float(ddir.std()) == pytest.approx(20.0, rel=0.03)
    lo, hi = cell.traffic["speed_clip"]
    assert float(s["wspd"].min()) >= lo and float(s["wspd"].max()) <= hi


def test_wind_fields_are_smooth_at_the_feature_scale(cell):
    s = scenes(cell, 6)[0]
    speed = s["wspd"].reshape(s["shape"])
    # neighbouring pixels differ far less than pixels a feature apart
    near = float(torch.diff(speed, dim=1).abs().mean())
    feature_px = int(cell.traffic["feature_km"] * 1000 / cell.traffic["pixel_m"])
    far = float((speed[:, feature_px:] - speed[:, :-feature_px]).abs().mean())
    assert near < far / 20


def test_dsig_cr_follows_the_configured_scheme(root, cell):
    s = scenes(cell, 8)[0]
    nesz = 10.0 ** (cell.traffic["nesz_cr_db"] / 10.0)
    c = 1.46852088 + 1.4058646 / (1.0 + np.exp(-1.57952257 * (s["inc"].numpy() - 25.61843791)))
    want = 1.0 / np.sqrt((s["s0_cr"].numpy() / nesz) ** c)
    np.testing.assert_allclose(s["dsig_cr"].numpy(), want, rtol=1e-12)
    lut = Cell(root, "lut_scansar_resident")
    lut.traffic = dict(lut.traffic, lines=4, samples=8)
    s = T.make_scene(lut.traffic, lut.config, T.generator(1, CPU),
                     {"speed_mean": 7.0, "land": 0.0}, CPU)
    assert torch.equal(s["dsig_cr"], torch.full_like(s["dsig_cr"], 0.1))
