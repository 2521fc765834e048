"""Analytic Geophysical Model Functions (GMFs) as torch elementwise code.

Counterpart of ``xsarsea_tpu.models.gmfs_impl``: the same 13 GMFs with the
same coefficient tables and the same op order, branchless (the published
scalar ``if``s become ``torch.where``) and broadcasting.

* CMOD5 (Hersbach et al. 2007) and CMOD5.N (neutral winds, Hersbach 2010).
* HH variants of CMOD5.N through the Zhang and Mouche et al. (2005)
  polarization ratios.
* CMOD-IFR2 (IFREMER, Quilfen et al.) VV GMF.
* The sarwing two-zone cross-pol (VH) family: RS2 v2/v3/v4, S1 v2 and
  v3-EW, RCM noaa/v3/v4, as one parameterized kernel.

Inputs may be tensors, numpy arrays or Python numbers; non-tensors become
float64 tensors (on the first tensor input's device and dtype, if any).
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.models.gmf import GmfModel

__all__ = [
    "cmod5",
    "gmf_cmod5",
    "gmf_cmod5n",
    "gmf_cmod5n_pr_zhangA",
    "gmf_cmod5n_pr_mouche1",
    "gmf_cmodifr2",
    "gmf_rs2_v2",
    "gmf_s1_v2",
    "gmf_rcm_noaa",
    "gmf_s1_v3_ew_rec",
    "gmf_rs2_v3",
    "gmf_rcm_v3",
    "gmf_rcm_v4",
    "gmf_rs2_v4",
    "register_builtin_gmfs",
]


def _tensors(*xs):
    """Convert the GMF arguments to tensors of one floating dtype/device.

    A missing (None) argument raises TypeError: GmfModel's phi probe relies
    on it to tell phi-dependent GMFs from phi-independent ones.
    """
    if any(x is None for x in xs):
        raise TypeError("missing GMF argument")
    like = next((x for x in xs if isinstance(x, torch.Tensor) and x.is_floating_point()), None)
    dtype = like.dtype if like is not None else torch.float64
    device = like.device if like is not None else torch.device("cpu")
    return tuple(x.to(dtype=dtype, device=device) if isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                                      device=device)
                 for x in xs)


# ----------------------------------------------------------------- CMOD5(.N)

# Published 28-coefficient sets (index 1..28; slot 0 unused).
_CMOD5_COEFS = np.array([
    0.0, -0.688, -0.793, 0.338, -0.173, 0.0, 0.004, 0.111, 0.0162, 6.34,
    2.57, -2.18, 0.4, -0.6, 0.045, 0.007, 0.33, 0.012, 22.0, 1.95,
    3.0, 8.39, -3.44, 1.36, 5.35, 1.99, 0.29, 3.80, 1.53,
])

_CMOD5N_COEFS = np.array([
    0.0, -0.6878, -0.7957, 0.338, -0.1728, 0.0, 0.004, 0.1103, 0.0159, 6.7329,
    2.7713, -2.2885, 0.4971, -0.725, 0.045, 0.0066, 0.3222, 0.012, 22.7, 2.0813,
    3.0, 8.3659, -3.3428, 1.3236, 6.2437, 2.3893, 0.3249, 4.159, 1.693,
])


def cmod5(inc, wspd, phi, neutral=True):
    """CMOD5 / CMOD5.N forward model: sigma0_linear(inc_deg, wspd_m/s, phi_deg).

    ``phi`` is the wind direction relative to the antenna look direction.
    """
    c = [float(v) for v in (_CMOD5N_COEFS if neutral else _CMOD5_COEFS)]
    inc, wspd, phi = _tensors(inc, wspd, phi)

    zpow = 1.6
    thetm, thethr = 40.0, 25.0
    y0, pn = c[19], c[20]
    a_pn = y0 - (y0 - 1.0) / pn
    b_pn = 1.0 / (pn * (y0 - 1.0) ** (pn - 1.0))

    cosphi = torch.cos(torch.deg2rad(phi))
    x = (inc - thetm) / thethr
    x2 = x * x

    # B0: power-law in wind speed with saturation
    a0 = c[1] + c[2] * x + c[3] * x2 + c[4] * x * x2
    a1 = c[5] + c[6] * x
    a2 = c[7] + c[8] * x
    gam = c[9] + c[10] * x + c[11] * x2
    s0 = c[12] + c[13] * x
    s = a2 * wspd
    a3_base = 1.0 / (1.0 + torch.exp(-s0))
    # scalar branch `if s < s0` -> where; guard the unselected branch's
    # power against s0 <= 0 (inc > ~57 deg)
    s0_safe = torch.where(s0 > 0, s0, torch.ones_like(s0))
    low = a3_base * (s / s0_safe) ** (s0_safe * (1.0 - a3_base))
    high = 1.0 / (1.0 + torch.exp(-s))
    a3 = torch.where(s < s0, low, high)
    b0 = (a3 ** gam) * 10.0 ** (a0 + a1 * wspd)

    # B1: upwind/downwind asymmetry
    b1 = c[15] * wspd * (0.5 + x - torch.tanh(4.0 * (x + c[16] + c[17] * wspd)))
    b1 = (c[14] * (1.0 + x) - b1) / (torch.exp(0.34 * (wspd - c[18])) + 1.0)

    # B2: upwind/crosswind modulation
    v0 = c[21] + c[22] * x + c[23] * x2
    d1 = c[24] + c[25] * x + c[26] * x2
    d2 = c[27] + c[28] * x
    v2 = wspd / v0 + 1.0
    v2 = torch.where(v2 < y0, a_pn + b_pn * (v2 - 1.0) ** pn, v2)
    b2 = (-d1 + d2 * v2) * torch.exp(-v2)

    return b0 * (1.0 + b1 * cosphi + b2 * (2.0 * cosphi * cosphi - 1.0)) ** zpow


def _pr_zhangA(inc, wspd):
    """Zhang polarization ratio PR(inc, wspd) for VV->HH conversion."""
    ar = 1.3794 + (-3.19e-2) * inc + 1.4e-3 * inc ** 2
    br = -0.1711 + 2.6e-3 * inc
    return ar * wspd ** br


def _pr_mouche1(inc, phi):
    """Mouche et al. (2005) polarization ratio PR(inc, phi) for VV->HH."""
    p0 = 0.00650704 * torch.exp(0.128983 * inc) + 0.992839
    ppi2 = 0.00782194 * torch.exp(0.121405 * inc) + 0.992839
    ppi = 0.00598416 * torch.exp(0.140952 * inc) + 0.992885
    c0 = (p0 + ppi + 2.0 * ppi2) / 4.0
    c1 = (p0 - ppi) / 2.0
    c2 = (p0 + ppi - 2.0 * ppi2) / 4.0
    phir = torch.deg2rad(phi)
    return c0 + c1 * torch.cos(phir) + c2 * torch.cos(2.0 * phir)


def gmf_cmod5(inc, wspd, phi):
    return cmod5(inc, wspd, phi, neutral=False)


def gmf_cmod5n(inc, wspd, phi):
    return cmod5(inc, wspd, phi, neutral=True)


def gmf_cmod5n_pr_zhangA(inc, wspd, phi):
    """HH sigma0: CMOD5.N divided by the Zhang polarization ratio."""
    inc, wspd, phi = _tensors(inc, wspd, phi)
    return cmod5(inc, wspd, phi, neutral=True) / _pr_zhangA(inc, wspd)


def gmf_cmod5n_pr_mouche1(inc, wspd, phi):
    """HH sigma0: CMOD5.N divided by the Mouche-1 polarization ratio."""
    inc, wspd, phi = _tensors(inc, wspd, phi)
    return cmod5(inc, wspd, phi, neutral=True) / _pr_mouche1(inc, phi)


# --------------------------------------------------------------- CMOD-IFR2

_IFR2_C = np.array([
    0.0, -2.437597, -1.5670307, 0.3708242, -0.040590, 0.404678, 0.188397,
    -0.027262, 0.064650, 0.054500, 0.086350, 0.055100, -0.058450, -0.096100,
    0.412754, 0.121785, -0.024333, 0.072163, -0.062954, 0.015958, -0.069514,
    -0.062945, 0.035538, 0.023049, 0.074654, -0.014713,
])


def gmf_cmodifr2(inc, wspd, phi):
    """CMOD-IFR2 VV GMF: Legendre expansion in incidence for B0, Chebyshev
    expansion in (normalized incidence, normalized wind) for B1/B2."""
    C = [float(v) for v in _IFR2_C]
    inc, wspd, phi = _tensors(inc, wspd, phi)

    t = (inc - 36.0) / 19.0
    tsq = t * t
    p1, p2, p3 = t, (3.0 * tsq - 1.0) / 2.0, (5.0 * tsq - 3.0) * t / 2.0
    alph = C[1] + C[2] * p1 + C[3] * p2 + C[4] * p3
    beta = C[5] + C[6] * p1 + C[7] * p2

    cosi = torch.cos(torch.deg2rad(phi))
    cos2i = 2.0 * cosi * cosi - 1.0

    tn = (2.0 * inc - (18.0 + 58.0)) / (58.0 - 18.0)
    vn = (2.0 * wspd - (25.0 + 3.0)) / (25.0 - 3.0)
    pv1 = vn
    pv2 = 2.0 * vn * pv1 - 1.0
    pv3 = 2.0 * vn * pv2 - pv1
    pt1 = tn
    pt2 = 2.0 * tn * pt1 - 1.0

    b1 = C[8] + C[9] * pv1 + (C[10] + C[11] * pv1) * pt1 + (C[12] + C[13] * pv1) * pt2
    b2 = (
        C[14] + C[15] * pt1 + C[16] * pt2
        + (C[17] + C[18] * pt1 + C[19] * pt2) * pv1
        + (C[20] + C[21] * pt1 + C[22] * pt2) * pv2
        + (C[23] + C[24] * pt1 + C[25] * pt2) * pv3
    )

    b0 = 10.0 ** (alph + beta * torch.sqrt(wspd))
    return b0 * (1.0 + b1 * cosi + torch.tanh(b2) * cos2i)


# ------------------------------------------------- cross-pol two-zone family
#
# Every sarwing VH GMF has two power-law zones sig_Zk = a_k(inc) * u^b_k(inc)
# with quadratic-in-incidence exponents, blended by two sigmoids in u.
#   z1 = (a0, b0, b1)                       sig_Z1 = a0 * u ** (b0 + b1*inc)
#   z2 = (a0, a1, a2, b0, b1, b2)           sig_Z2 = A(inc) * u ** B(inc)
#   blend = (c0, c1, c2, c3)                sigmoids 1/(1+exp(-c*(u-c1)))
#   db_blend: blend the two zones in dB space instead of linear space
_XPOL_PARAMS = {
    "gmf_rs2_v2": dict(
        z1=(6.55519203e-06, 2.49753154e00, -1.35734881e-02),
        z2=(1.47342197e-04, -4.07334797e-06, 3.43593382e-08,
            1.10188639e00, 1.40782758e-02, -1.53748743e-04),
        blend=(-0.18675905, 24.48859492, 0.19185442, 25.38275738),
        db_blend=False,
    ),
    "gmf_s1_v2": dict(
        z1=(2.13755392e-06, 2.47395267e00, -2.85775085e-03),
        z2=(6.54058552e-05, -2.43845137e-06, 2.87698338e-08,
            1.14509104e00, 3.41828829e-02, -4.79715441e-04),
        blend=(-0.23257086, 12.39717002, 0.21667263, 12.22862991),
        db_blend=False,
    ),
    "gmf_rcm_noaa": dict(
        z1=(2.2309436836414871e-12, 8.3374911282878728, -0.033443488982800210),
        z2=(7.7945050373193260e-05, -2.4425748662769216e-06, 2.7625550632547159e-08,
            1.2524896108831316, 0.019203092214131894, -0.00028408046502692580),
        blend=(-0.34498737004629487, 12.558975188752012,
               0.12713502524515713, 4.2806865431046752),
        db_blend=False,
    ),
    "gmf_s1_v3_ew_rec": dict(
        z1=(3.5033427638479895e-06, 2.5486758595982275, -0.009042529888607539),
        z2=(4.142689709809047e-05, -1.6620917447744406e-06, 2.4331104610101826e-08,
            1.277314996198736, 0.03813903872809897, -0.0006506765114704733),
        blend=(-0.2522916645939956, 15.3393676653533,
               0.24259895576004784, 15.203063214062643),
        db_blend=True,
    ),
    "gmf_rs2_v3": dict(
        z1=(8.423384272498706e-06, 2.4351127340627374, -0.01450322326682606),
        z2=(0.00014955206131320428, -4.737691852310481e-06, 3.813107432709729e-08,
            1.524883207000445, -0.01322253424944054, 0.00037527120092119504),
        blend=(-0.2222881984904166, 13.118282628673661,
               0.21426139278646567, 12.768845054319682),
        db_blend=True,
    ),
    "gmf_rcm_v3": dict(
        z1=(7.093964676135241e-06, 2.3722948391886542, -0.009516840375089524),
        z2=(6.689451099284358e-05, -1.3956325894252652e-06, 9.227949977841212e-09,
            1.4687699534267797, 0.005735224541037088, -7.164130353316848e-05),
        blend=(-0.2454472887447197, 15.537961353644508,
               0.24011368010838255, 15.332883245452303),
        db_blend=True,
    ),
}


def _xpol_v4(params):
    """v4 variants: v3 constants with the zone-2 exponent intercept scaled
    by 1.01 (reference gmfs_impl.py:662, 701)."""
    z2 = list(params["z2"])
    z2[3] = z2[3] * 1.01
    out = dict(params)
    out["z2"] = tuple(z2)
    return out


_XPOL_PARAMS["gmf_rcm_v4"] = _xpol_v4(_XPOL_PARAMS["gmf_rcm_v3"])
_XPOL_PARAMS["gmf_rs2_v4"] = _xpol_v4(_XPOL_PARAMS["gmf_rs2_v3"])


def _xpol_two_zone(inc, u10, z1, z2, blend, db_blend):
    """Shared two-zone cross-pol kernel: sigma0_linear(inc, wspd)."""
    inc, u10 = _tensors(inc, u10)
    a_z1, b0_z1, b1_z1 = z1
    sig_z1 = a_z1 * u10 ** (b0_z1 + b1_z1 * inc)

    a0, a1, a2, b0, b1, b2 = z2
    a_z2 = a0 + a1 * inc + a2 * inc * inc
    b_z2 = b0 + b1 * inc + b2 * inc * inc
    sig_z2 = a_z2 * u10 ** b_z2

    c0, c1, c2, c3 = blend
    s1 = 1.0 / (1.0 + torch.exp(-c0 * (u10 - c1)))
    s2 = 1.0 / (1.0 + torch.exp(-c2 * (u10 - c3)))

    if db_blend:
        return 10.0 ** ((10.0 * torch.log10(sig_z1) * s1
                         + 10.0 * torch.log10(sig_z2) * s2) / 10.0)
    return sig_z1 * s1 + sig_z2 * s2


def _make_xpol_gmf(name):
    params = _XPOL_PARAMS[name]

    def gmf(incidence, speed, phi=None):
        return _xpol_two_zone(incidence, speed, params["z1"], params["z2"],
                              params["blend"], params["db_blend"])

    gmf.__name__ = name
    gmf.__doc__ = f"{name}: VH two-zone cross-pol GMF, sigma0_linear(inc_deg, wspd_m/s)."
    return gmf


gmf_rs2_v2 = _make_xpol_gmf("gmf_rs2_v2")
gmf_s1_v2 = _make_xpol_gmf("gmf_s1_v2")
gmf_rcm_noaa = _make_xpol_gmf("gmf_rcm_noaa")
gmf_s1_v3_ew_rec = _make_xpol_gmf("gmf_s1_v3_ew_rec")
gmf_rs2_v3 = _make_xpol_gmf("gmf_rs2_v3")
gmf_rcm_v3 = _make_xpol_gmf("gmf_rcm_v3")
gmf_rcm_v4 = _make_xpol_gmf("gmf_rcm_v4")
gmf_rs2_v4 = _make_xpol_gmf("gmf_rs2_v4")


def register_builtin_gmfs():
    """Register every built-in analytic GMF in the model registry (idempotent)."""
    copol = dict(wspd_range=[0.2, 50.0], units="linear")
    xpol = dict(wspd_range=[3.0, 80.0], units="linear")

    GmfModel.register_function(gmf_cmod5, "gmf_cmod5", pol="VV", **copol)
    GmfModel.register_function(gmf_cmod5n, "gmf_cmod5n", pol="VV", **copol)
    GmfModel.register_function(gmf_cmod5n_pr_zhangA, "gmf_cmod5n_pr_zhangA", pol="HH", **copol)
    GmfModel.register_function(gmf_cmod5n_pr_mouche1, "gmf_cmod5n_pr_mouche1", pol="HH",
                               **copol)
    GmfModel.register_function(gmf_cmodifr2, "gmf_cmodifr2", pol="VV", **copol)
    for name in _XPOL_PARAMS:
        GmfModel.register_function(globals()[name], name, pol="VH", **xpol)


register_builtin_gmfs()
