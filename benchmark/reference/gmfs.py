"""Frozen plain copies of the GMFs and the dsig scheme the benchmark runs.

Copied from the port (``xsarsea_tpu_torch/models/gmfs_impl.py`` and
``windspeed/dsig.py``) with the same coefficients and the same operation
order, so that later edits to the program cannot move the yardstick. Plain
PyTorch: tensors in, tensors out, in the inputs' dtype and device.

* ``gmf_cmod5n``: CMOD5.N (Hersbach 2010), VV sigma0 (linear) of incidence
  (deg), 10 m neutral wind speed (m/s) and wind direction relative to the
  antenna look (deg).
* ``gmf_s1_v2``: the sarwing two-zone VH GMF for Sentinel-1, sigma0 (linear)
  of incidence and speed.
* ``dsig_s1_v2``: the ``gmf_s1_v2`` weighting of the crosspol cost term from
  the crosspol SNR (xsarsea ``windspeed/utils.py`` ``get_dsig``).
"""

from __future__ import annotations

import torch

_CMOD5N = (
    0.0, -0.6878, -0.7957, 0.338, -0.1728, 0.0, 0.004, 0.1103, 0.0159, 6.7329,
    2.7713, -2.2885, 0.4971, -0.725, 0.045, 0.0066, 0.3222, 0.012, 22.7, 2.0813,
    3.0, 8.3659, -3.3428, 1.3236, 6.2437, 2.3893, 0.3249, 4.159, 1.693,
)

_S1_V2 = dict(
    z1=(2.13755392e-06, 2.47395267e00, -2.85775085e-03),
    z2=(6.54058552e-05, -2.43845137e-06, 2.87698338e-08,
        1.14509104e00, 3.41828829e-02, -4.79715441e-04),
    blend=(-0.23257086, 12.39717002, 0.21667263, 12.22862991),
)


def gmf_cmod5n(inc, wspd, phi):
    c = _CMOD5N
    zpow = 1.6
    thetm, thethr = 40.0, 25.0
    y0, pn = c[19], c[20]
    a_pn = y0 - (y0 - 1.0) / pn
    b_pn = 1.0 / (pn * (y0 - 1.0) ** (pn - 1.0))

    cosphi = torch.cos(torch.deg2rad(phi))
    x = (inc - thetm) / thethr
    x2 = x * x

    a0 = c[1] + c[2] * x + c[3] * x2 + c[4] * x * x2
    a1 = c[5] + c[6] * x
    a2 = c[7] + c[8] * x
    gam = c[9] + c[10] * x + c[11] * x2
    s0 = c[12] + c[13] * x
    s = a2 * wspd
    a3_base = 1.0 / (1.0 + torch.exp(-s0))
    s0_safe = torch.where(s0 > 0, s0, torch.ones_like(s0))
    low = a3_base * (s / s0_safe) ** (s0_safe * (1.0 - a3_base))
    high = 1.0 / (1.0 + torch.exp(-s))
    a3 = torch.where(s < s0, low, high)
    b0 = (a3 ** gam) * 10.0 ** (a0 + a1 * wspd)

    b1 = c[15] * wspd * (0.5 + x - torch.tanh(4.0 * (x + c[16] + c[17] * wspd)))
    b1 = (c[14] * (1.0 + x) - b1) / (torch.exp(0.34 * (wspd - c[18])) + 1.0)

    v0 = c[21] + c[22] * x + c[23] * x2
    d1 = c[24] + c[25] * x + c[26] * x2
    d2 = c[27] + c[28] * x
    v2 = wspd / v0 + 1.0
    v2 = torch.where(v2 < y0, a_pn + b_pn * (v2 - 1.0) ** pn, v2)
    b2 = (-d1 + d2 * v2) * torch.exp(-v2)

    return b0 * (1.0 + b1 * cosphi + b2 * (2.0 * cosphi * cosphi - 1.0)) ** zpow


def gmf_s1_v2(inc, wspd):
    a_z1, b0_z1, b1_z1 = _S1_V2["z1"]
    sig_z1 = a_z1 * wspd ** (b0_z1 + b1_z1 * inc)
    a0, a1, a2, b0, b1, b2 = _S1_V2["z2"]
    a_z2 = a0 + a1 * inc + a2 * inc * inc
    b_z2 = b0 + b1 * inc + b2 * inc * inc
    sig_z2 = a_z2 * wspd ** b_z2
    c0, c1, c2, c3 = _S1_V2["blend"]
    s1 = 1.0 / (1.0 + torch.exp(-c0 * (wspd - c1)))
    s2 = 1.0 / (1.0 + torch.exp(-c2 * (wspd - c3)))
    return sig_z1 * s1 + sig_z2 * s2


def dsig_s1_v2(inc, sigma0_cr, nesz_cr):
    c0, c1, d0, d1 = 1.57952257, 25.61843791, 1.46852088, 1.4058646
    c = d0 + d1 / (1.0 + torch.exp(-c0 * (inc - c1)))
    return 1.0 / torch.sqrt((sigma0_cr / nesz_cr) ** c)


GMFS = {"gmf_cmod5n": gmf_cmod5n, "gmf_s1_v2": gmf_s1_v2}
DSIG_SCHEMES = {"gmf_s1_v2": dsig_s1_v2}
