"""The one scene generator: a traffic file's parameters and a seed in, a pool
of distinct scenes out, made on the device.

A traffic file (``benchmark/traffic/<name>.json``) states:

* ``lines``, ``samples``, ``pixel_m``: the scene's shape and pixel size;
* ``incidence_deg``: the ramp of incidence along the sample axis (the same on
  every line), as a SAR swath has it;
* ``pool``: how many distinct scenes the cell cycles through;
* ``speed_mean`` (m/s, uniform over the pool), ``speed_std`` (m/s),
  ``speed_clip`` (m/s), ``direction_std_deg`` and ``feature_km``: smooth wind
  fields, a seeded random field on a grid of ``feature_km`` spacing
  upsampled bilinearly to the pixels, around a per-scene mean speed and a
  uniform per-scene direction (relative to the antenna look);
* ``noise_db``: multiplicative speckle of the forward-modelled sigma0,
  ``10 ** (N(0, sd) / 10)``, per polarisation (``co``, ``cr``);
* ``ancillary``: the prior wind, the truth with ``N(0, speed_sd)`` m/s on the
  speed (clipped at 0.2) and ``N(0, direction_sd_deg)`` on the direction;
* ``land``: scenes ``j`` with ``j % every == every - 1`` carry a contiguous
  coastal block, a fraction ``U(fraction)`` of the samples (uniform over the
  coastal scenes) on one side (drawn), whose sigma0 is NaN;
* ``nesz_cr_db``: the crosspol noise floor, for a configuration whose
  ``dsig_cr`` is a scheme of the crosspol SNR;
* ``entry``: how the scenes reach the program (``benchmark/entries/<entry>.py``).

The work a scene costs depends on its mean speed and its land, so every seed
gets the same set of them and the seed draws their order: the pool's mean
speeds are the midpoints of ``pool`` equal slices of ``speed_mean``, its
coastal scenes' land fractions those of equal slices of ``fraction``, each
set dealt to the scenes in an order drawn from the seed. The seed draws the
rest: the directions, the wind fields, the noise, the side of the coast.

The sigma0 are forward-modelled in float64 by the configuration's ``forward``
GMFs (the frozen copies). A scene is a dict of flat float64 tensors ``inc``,
``wspd``, ``phi`` (truth), ``s0_co``, ``s0_cr`` (linear), ``anc_re``,
``anc_im``, ``dsig_cr``, and ``shape``. The same seed gives the same scenes;
every seed gives scenes of the same sizes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.gmfs import DSIG_SCHEMES, GMFS

_BLOCK_LINES_PX = 1 << 23  # pixels forward-modelled at once


def _smooth_field(gen, lines, samples, cells_l, cells_s, device):
    """A unit-variance random field on a coarse grid, upsampled bilinearly."""
    coarse = torch.randn((1, 1, cells_l, cells_s), generator=gen, dtype=torch.float64,
                         device=device)
    return F.interpolate(coarse, size=(lines, samples), mode="bilinear",
                         align_corners=True)[0, 0]


def _levels(k, lo, hi, gen):
    """The midpoints of ``k`` equal slices of [lo, hi], in an order drawn
    from ``gen``."""
    order = torch.randperm(k, generator=gen, device=gen.device).tolist()
    return [lo + (hi - lo) * (i + 0.5) / k for i in order]


def scene_plan(traffic, gen):
    """Each scene's mean speed and land fraction (0 for a scene with no
    coast), the same set for every seed."""
    pool = int(traffic["pool"])
    land = traffic["land"]
    coastal = [j for j in range(pool) if j % land["every"] == land["every"] - 1]
    speeds = _levels(pool, *traffic["speed_mean"], gen)
    fractions = dict(zip(coastal, _levels(len(coastal), *land["fraction"], gen)))
    return [{"speed_mean": speeds[j], "land": fractions.get(j, 0.0)} for j in range(pool)]


def make_scene(traffic, config, gen, plan, device):
    """One scene of the plan (an entry of :func:`scene_plan`)."""
    lines, samples = int(traffic["lines"]), int(traffic["samples"])
    n = lines * samples
    f64 = dict(dtype=torch.float64, device=device)

    def uniform(lo, hi):
        return lo + (hi - lo) * float(torch.rand((), generator=gen, **f64))

    inc0, inc1 = traffic["incidence_deg"]
    ramp = torch.linspace(inc0, inc1, samples, **f64)
    inc = ramp.expand(lines, samples).reshape(-1)

    feature_px = traffic["feature_km"] * 1000.0 / traffic["pixel_m"]
    cells_l = max(2, math.ceil(lines / feature_px) + 1)
    cells_s = max(2, math.ceil(samples / feature_px) + 1)
    speed = plan["speed_mean"] \
        + traffic["speed_std"] * _smooth_field(gen, lines, samples, cells_l, cells_s, device)
    speed = speed.reshape(-1).clamp(*traffic["speed_clip"])
    phi = uniform(0.0, 360.0) + traffic["direction_std_deg"] * _smooth_field(
        gen, lines, samples, cells_l, cells_s, device).reshape(-1)

    gmf_co, gmf_cr = (GMFS[name] for name in config["forward"])
    s0_co = torch.empty(n, **f64)
    s0_cr = torch.empty(n, **f64)
    for lo in range(0, n, _BLOCK_LINES_PX):
        hi = min(lo + _BLOCK_LINES_PX, n)
        s0_co[lo:hi] = gmf_co(inc[lo:hi], speed[lo:hi], phi[lo:hi])
        s0_cr[lo:hi] = gmf_cr(inc[lo:hi], speed[lo:hi])
    for s0, sd in ((s0_co, traffic["noise_db"]["co"]), (s0_cr, traffic["noise_db"]["cr"])):
        s0 *= 10.0 ** (torch.randn(n, generator=gen, **f64) * (sd / 10.0))

    anc = traffic["ancillary"]
    anc_speed = (speed + anc["speed_sd"] * torch.randn(n, generator=gen, **f64)).clamp(min=0.2)
    anc_dir = torch.deg2rad(phi + anc["direction_sd_deg"] * torch.randn(n, generator=gen,
                                                                        **f64))
    if plan["land"] > 0:
        width = round(plan["land"] * samples)
        far = uniform(0.0, 1.0) < 0.5
        cols = slice(samples - width, samples) if far else slice(0, width)
        for s0 in (s0_co, s0_cr):
            s0.view(lines, samples)[:, cols] = math.nan

    dsig = config["dsig_cr"]
    if "scheme" in dsig:
        nesz = 10.0 ** (traffic["nesz_cr_db"] / 10.0)
        dsig_cr = DSIG_SCHEMES[dsig["scheme"]](inc, s0_cr, torch.full_like(s0_cr, nesz))
    else:
        dsig_cr = torch.full((n,), float(dsig["value"]), **f64)
    return {"shape": (lines, samples), "inc": inc, "wspd": speed, "phi": phi,
            "s0_co": s0_co, "s0_cr": s0_cr, "anc_re": anc_speed * torch.cos(anc_dir),
            "anc_im": anc_speed * torch.sin(anc_dir), "dsig_cr": dsig_cr}


def generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen
