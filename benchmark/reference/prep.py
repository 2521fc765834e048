"""The judge's plain reference of xsarsea's L1 scene preparation, for the
cells whose program weights the crosspol channel from its raw NESZ (a copy of
the repository tests' ``tests/_prep_reference.py``), in float64 PyTorch:
``nesz_flattening`` (xsarsea ``windspeed/utils.py:94-163``) and ``get_dsig``
(``utils.py:47-91``), written from the reference's own steps and not from
the port's; it imports neither the port nor JAX.

``nesz_flattening`` follows the reference literally: the incidence's mean
over the lines, the NESZ's NaN samples replaced by their column's mean, then
row by row the NESZ in dB, its finite samples, and an order-1 polynomial fit
of them against the incidence (``np.polyfit``: here the row's normal
equations, solved for all rows at once with ``torch.linalg.solve``), 1 dB
taken off and back to linear. A row without a finite sample raises in
``np.polyfit`` (the reference's TypeError path) and comes out NaN; a row with
a single one, which ``np.polyfit`` fits with a rank warning, comes out NaN
too.
"""

from __future__ import annotations

import math

import torch

DSIG_NAMES = ("gmf_s1_v2", "gmf_rs2_v2", "sarwing_lut_cmodms1ahw", "nc_lut_cmodms1ahw")


def nesz_flattening(noise, inc):
    """Flattened NESZ of the (line, sample) linear ``noise``; ``inc`` the
    scene's incidence, (line, sample) or a (sample,) vector."""
    noise = torch.as_tensor(noise, dtype=torch.float64)
    inc = torch.as_tensor(inc, dtype=torch.float64, device=noise.device)
    inc_1d = torch.nanmean(inc, dim=0) if inc.ndim == 2 else inc
    filled = torch.where(torch.isnan(noise), torch.nanmean(noise, dim=0), noise)
    noise_db = 10.0 * torch.log10(filled)
    finite = torch.isfinite(noise_db)
    # each row's normal equations of the fit y = a x + b over its finite samples
    x = torch.where(finite, inc_1d, 0.0)
    y = torch.where(finite, noise_db, 0.0)
    n = finite.sum(1).to(torch.float64)
    sx, sy = x.sum(1), y.sum(1)
    sxx, sxy = (x * x).sum(1), (x * y).sum(1)
    fits = n >= 2
    lhs = torch.stack([torch.stack([sxx, sx], -1), torch.stack([sx, n], -1)], -2)
    lhs = torch.where(fits[:, None, None], lhs, torch.eye(2, dtype=lhs.dtype, device=lhs.device))
    coef = torch.linalg.solve(lhs, torch.stack([sxy, sy], -1)[..., None])[..., 0]
    coef = torch.where(fits[:, None], coef, math.nan)
    return 10.0 ** ((inc_1d * coef[:, :1] + coef[:, 1:] - 1.0) / 10.0)


def get_dsig(name, inc, sigma0_cr, nesz_cr):
    """The named ``dsig_cr`` scheme, elementwise, in float64."""
    inc, s0, nesz = (torch.as_tensor(a, dtype=torch.float64) for a in (inc, sigma0_cr, nesz_cr))
    if name == "gmf_s1_v2":
        c0, c1, d0, d1 = 1.57952257, 25.61843791, 1.46852088, 1.4058646
        c = d0 + d1 / (1.0 + torch.exp(-c0 * (inc - c1)))
        return 1.0 / torch.sqrt((s0 / nesz) ** c)
    if name == "gmf_rs2_v2":
        return 1.0 / torch.sqrt((s0 / nesz) ** 8.0)
    if name in DSIG_NAMES:
        return (1.25 / (s0 / nesz)) ** 4.0
    raise ValueError(f"dsig scheme {name!r} is not handled")


def dsig_from_nesz(name, inc, sigma0_cr, nesz_cr):
    """The L1 example's two preparation calls: the flattened NESZ, then the
    scheme's ``dsig_cr`` of the (line, sample) scene."""
    flat = nesz_flattening(nesz_cr, inc)
    inc = torch.as_tensor(inc, dtype=torch.float64, device=flat.device)
    return get_dsig(name, inc.expand(flat.shape), sigma0_cr, flat)
