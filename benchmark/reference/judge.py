"""The plain reference inversion and the judge of the program's winds.

Plain PyTorch, on the reference's own tables (:mod:`benchmark.reference.luts`).
Per pixel, as xsarsea's ``windspeed.py`` defines the inversion:

* copol: on the LUT slice of the nearest incidence (first minimum of
  ``|axis - inc|`` in float32), the cost
  ``((u - ma)/2)^2 + ((v - mz)/2)^2 + ((lut - s0)/dsig_co)^2`` over the
  whole (wspd, phi) grid (``mz`` taken as ``|mz|`` on a 0-180 degree LUT),
  the direction's sign then chosen nearest the ancillary direction;
* crosspol: on the crosspol slice of the nearest incidence,
  ``((lut - s0)/dsig_cr)^2 + ((w - |wind_co|)/2)^2`` over the speeds (the
  prior only where copol solved), the direction taken from copol;
* NaN incidence, or a valid copol sigma0 with a NaN ancillary wind, gives NaN
  winds; a NaN sigma0 a NaN wind of its polarisation;
* the dual-pol merge of ``invert_from_model``: copol where either speed is
  below 5 m/s.

:meth:`Judge.judge` holds the program's winds on a sample of pixels to this:
each chosen wind is decoded back to its grid cell and its cost is compared,
in float64, with the least cost of the grid. A gap, not a difference of
winds: two cells whose costs tie to rounding may both be right. The crosspol
cost takes the program's own copol speed as its prior, so that each stage is
judged on its own. :meth:`Judge.invert` is the reference in the program's
place, in any precision (the control runs it in bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

DSIG_PRIOR = 2.0  # the cost's wind terms: (du/2)^2, (dv/2)^2, (dw/2)^2
MERGE_BELOW = 5.0  # m/s: the dual-pol merge takes copol below this speed
GRID_TOL = 1e-3  # m/s and degrees: a decoded wind lies on its grid cell
OFF_GRID = 1e30  # the gap of a wind that lies on no grid cell
ANGLE_TOL = 1e-4  # rad: same direction; also the width of a sign tie
# a copol wind whose cost lies more than this above the grid's least misses
# the exact argmin's cell: float32 costs tie to ~1e-5, the fused coarse pass's
# misses of a near-equal second minimum lie above ~5e-3
MISS_GAP = 1e-3


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def nearest(axis32, v32):
    """First minimum of ``|axis - v|`` in float32 (numpy's argmin rule)."""
    d = torch.abs(axis32[None, :] - v32[:, None])
    return torch.argmin(d, dim=1)


def _snap(values, grid):
    """Index of the grid cell nearest each value, and whether it lies on it."""
    step = float(torch.median(torch.diff(grid)))
    idx = torch.round((values - grid[0]) / step).clamp(0, grid.shape[0] - 1).long()
    on = torch.abs(values - grid[idx]) <= GRID_TOL
    return idx, on


class Judge:
    """The reference tables on ``device`` (float64 copies of the float32
    values) and the comparisons."""

    def __init__(self, tables, dsig_co, device, block=256):
        f64 = dict(dtype=torch.float64, device=device)
        t = tables
        self.device = device
        self.block = block
        self.dsig_co = float(dsig_co)
        self.phi_180 = t.phi_180
        self.co_lut = torch.as_tensor(t.co_lut, **f64)
        self.co_u = torch.as_tensor(t.co_u, **f64)
        self.co_v = torch.as_tensor(t.co_v, **f64)
        self.co_wspd = torch.as_tensor(t.co_wspd, **f64)
        self.co_phi = torch.as_tensor(t.co_phi, **f64)
        self.co_inc32 = torch.as_tensor(t.co_inc, dtype=torch.float32, device=device)
        self.cr_lut = torch.as_tensor(t.cr_lut, **f64)
        self.cr_wspd = torch.as_tensor(t.cr_wspd, **f64)
        self.cr_inc32 = torch.as_tensor(t.cr_inc, dtype=torch.float32, device=device)

    # ------------------------------------------------------------ the costs

    def _copol_cost(self, i_co, s0, ma, mz, dtype, lo, hi):
        """Copol costs (B, W, P) of pixels [lo, hi) in ``dtype``."""
        c = lambda x: x.to(dtype)  # noqa: E731
        mz_eff = torch.abs(mz) if self.phi_180 else mz
        lut = c(self.co_lut[i_co[lo:hi]])
        jwind = ((c(self.co_u)[None] - c(ma[lo:hi])[:, None, None]) / DSIG_PRIOR) ** 2 \
            + ((c(self.co_v)[None] - c(mz_eff[lo:hi])[:, None, None]) / DSIG_PRIOR) ** 2
        jsig = ((lut - c(s0[lo:hi])[:, None, None]) / c(torch.tensor(self.dsig_co))) ** 2
        return jwind + jsig

    def _crosspol_cost(self, i_cr, s0_cr, dsig_cr, wco, has_co, dtype):
        """Crosspol costs (n, Wc) in ``dtype``; ``wco`` the copol speed prior."""
        c = lambda x: x.to(dtype)  # noqa: E731
        jsig = ((c(self.cr_lut[i_cr]) - c(s0_cr)[:, None]) / c(dsig_cr)[:, None]) ** 2
        jwind = ((c(self.cr_wspd)[None] - c(wco)[:, None]) / DSIG_PRIOR) ** 2
        return jsig + torch.where(has_co[:, None], jwind, torch.zeros_like(jwind))

    def _copol_min(self, i_co, s0, ma, mz):
        out = torch.empty(i_co.shape[0], dtype=torch.float64, device=self.device)
        for lo in range(0, i_co.shape[0], self.block):
            hi = min(lo + self.block, i_co.shape[0])
            j = self._copol_cost(i_co, s0, ma, mz, torch.float64, lo, hi)
            out[lo:hi] = torch.nan_to_num(j, nan=math.inf).flatten(1).amin(1)
        return out

    # ----------------------------------------------------------- the judge

    def judge(self, x, co, dual, merged):
        """Per-pixel verdicts on the program's winds ``co``, ``dual``
        (complex) for the inputs ``x`` (a dict of the sampled pixels' inputs
        as the program received them: ``inc`` float32, the rest float64).
        ``merged``: ``dual`` is after the dual-pol merge.

        Returns float64 ``co_gap``, ``dual_gap`` (cost above the grid's least
        cost; ``OFF_GRID`` for a wind off its grid) and bool ``post_error`` (a NaN
        where none is due or none where one is, a direction of the wrong sign
        outside a tie, a dual wind that does not take copol's direction, a
        merge not applied as defined), each 0 / False where nothing is due.
        """
        inc, s0, s0_cr = x["inc"], x["s0_co_db"], x["s0_cr_db"]
        dsig_cr, ma, mz = x["dsig_cr"], x["anc_re"], x["anc_im"]
        n = inc.shape[0]
        dev = self.device
        zeros = torch.zeros(n, dtype=torch.float64, device=dev)
        co_re, co_im = co.real.double(), co.imag.double()
        du_re, du_im = dual.real.double(), dual.imag.double()

        inc_ok = ~torch.isnan(inc)
        co_ok = ~torch.isnan(s0)
        cr_ok = ~torch.isnan(s0_cr) & ~torch.isnan(dsig_cr)
        guard = ~inc_ok | (co_ok & (torch.isnan(ma) | torch.isnan(mz)))
        co_due = ~guard & co_ok
        cr_due = ~guard & cr_ok

        wco = torch.hypot(co_re, co_im)
        co_nan = torch.isnan(wco)
        post = co_nan != ~co_due

        # copol: decode to the grid cell, its cost against the least
        i_co = nearest(self.co_inc32, torch.nan_to_num(inc.float()))
        phi_deg = torch.rad2deg(torch.atan2(co_im, co_re))
        a = torch.abs(phi_deg) if self.phi_180 else torch.remainder(phi_deg, 360.0)
        iw, on_w = _snap(wco.nan_to_num(), self.co_wspd)
        ip, on_p = _snap(a.nan_to_num(), self.co_phi)
        solved = co_due & ~co_nan
        mz_eff = torch.abs(mz) if self.phi_180 else mz
        jp = ((self.co_u[iw, ip] - ma) / DSIG_PRIOR) ** 2 \
            + ((self.co_v[iw, ip] - mz_eff) / DSIG_PRIOR) ** 2 \
            + ((self.co_lut[i_co, iw, ip] - s0) / self.dsig_co) ** 2
        co_gap = zeros.clone()
        idx = torch.nonzero(solved).reshape(-1)
        if idx.numel():
            jmin = self._copol_min(i_co[idx], s0[idx], ma[idx], mz[idx])
            co_gap[idx] = (jp[idx] - jmin).clamp(min=0)
        co_gap = torch.where(solved & ~(on_w & on_p), OFF_GRID, co_gap)
        if self.phi_180:
            phir = torch.deg2rad(self.co_phi[ip])
            anc_ang = torch.atan2(mz, ma)
            d1 = torch.abs(_wrap(anc_ang - phir))
            d2 = torch.abs(_wrap(anc_ang + phir))
            axis = (a < GRID_TOL) | (a > 180.0 - GRID_TOL)
            tie = torch.abs(d1 - d2) < ANGLE_TOL
            post |= solved & ~axis & ~tie & ((d1 <= d2) != (phi_deg > 0))

        # crosspol, its prior the program's own copol speed
        i_cr = nearest(self.cr_inc32, torch.nan_to_num(inc.float()))
        wco_grid = torch.where(solved, self.co_wspd[iw], 0.0)
        jcr = self._crosspol_cost(i_cr, s0_cr, dsig_cr, wco_grid, solved, torch.float64)
        jcr = torch.nan_to_num(jcr, nan=math.inf)
        jcr_min = jcr.amin(1)
        wdu = torch.hypot(du_re, du_im)
        du_nan = torch.isnan(wdu)
        iwd, on_d = _snap(wdu.nan_to_num(), self.cr_wspd)
        gap_of = lambda i: (jcr.gather(1, i[:, None])[:, 0] - jcr_min).clamp(min=0)  # noqa: E731
        ang_d = torch.atan2(du_im, du_re)
        same_dir = torch.where(solved, torch.abs(_wrap(ang_d - torch.atan2(co_im, co_re)))
                               <= ANGLE_TOL, (du_im == 0) & (du_re > 0))
        if not merged:
            post |= du_nan != ~cr_due
            has = cr_due & ~du_nan
            dual_gap = torch.where(has, torch.where(on_d, gap_of(iwd), OFF_GRID), 0.0)
            post |= has & ~same_dir
        else:
            # the merge: copol where either speed is below MERGE_BELOW; a
            # speed on the grid's 5 m/s cell ties (its float32 modulus may
            # fall either side), and either outcome is right there
            take_co = solved & (wco < MERGE_BELOW - GRID_TOL)
            may_take = solved & (wco < MERGE_BELOW + GRID_TOL)
            claim = ((du_re == co_re) | (torch.isnan(du_re) & torch.isnan(co_re))) \
                & ((du_im == co_im) | (torch.isnan(du_im) & torch.isnan(co_im)))
            post |= take_co & ~claim
            post |= ~cr_due & ~may_take & ~du_nan
            own = cr_due & ~take_co & ~claim
            below = self.cr_wspd < MERGE_BELOW + GRID_TOL
            jbelow = torch.where(below[None], jcr, math.inf).amin(1)
            iwc, on_c = _snap(wco.nan_to_num(), self.cr_wspd)
            at_co = torch.where(solved & on_c, jcr.gather(1, iwc[:, None])[:, 0], math.inf)
            claim_gap = (torch.minimum(jbelow, at_co) - jcr_min).clamp(min=0)
            own_gap = torch.where(on_d, gap_of(iwd), OFF_GRID)
            dual_gap = torch.where(own, own_gap, torch.where(cr_due & ~may_take & claim,
                                                             claim_gap, 0.0))
            post |= own & (du_nan | (wdu < MERGE_BELOW - GRID_TOL) | ~same_dir)
        return {"co_gap": co_gap, "dual_gap": dual_gap, "post_error": post}

    # ----------------------------------------------- the reference, in place

    def invert(self, x, dtype, merged):
        """The reference inversion of the pixels ``x`` with its costs in
        ``dtype``: complex64 winds, as the program returns them."""
        inc, s0, s0_cr = x["inc"], x["s0_co_db"], x["s0_cr_db"]
        dsig_cr, ma, mz = x["dsig_cr"], x["anc_re"], x["anc_im"]
        n = inc.shape[0]
        i_co = nearest(self.co_inc32, torch.nan_to_num(inc.float()))
        n_phi = self.co_phi.shape[0]
        flat = torch.empty(n, dtype=torch.int64, device=self.device)
        for lo in range(0, n, self.block):
            hi = min(lo + self.block, n)
            j = self._copol_cost(i_co, s0, ma, mz, dtype, lo, hi).flatten(1)
            isn = torch.isnan(j)
            first_nan = torch.argmax(isn.to(torch.int32), 1)
            first_min = torch.argmin(torch.where(isn, math.inf, j), 1)
            flat[lo:hi] = torch.where(isn.any(1), first_nan, first_min)
        wspd = self.co_wspd[flat // n_phi]
        phir = torch.deg2rad(self.co_phi[flat % n_phi])
        if self.phi_180:
            anc_ang = torch.atan2(mz, ma)
            d1 = torch.abs(_wrap(anc_ang - phir))
            d2 = torch.abs(_wrap(anc_ang + phir))
            phir = torch.where(d1 <= d2, phir, -phir)
        inc_ok = ~torch.isnan(inc)
        co_ok = ~torch.isnan(s0)
        guard = ~inc_ok | (co_ok & (torch.isnan(ma) | torch.isnan(mz)))
        wspd = torch.where(co_ok, wspd, math.nan)
        has_co = ~torch.isnan(wspd)
        i_cr = nearest(self.cr_inc32, torch.nan_to_num(inc.float()))
        jcr = self._crosspol_cost(i_cr, s0_cr, dsig_cr, torch.nan_to_num(wspd), has_co, dtype)
        isn = torch.isnan(jcr)
        icr = torch.where(isn.any(1), torch.argmax(isn.to(torch.int32), 1),
                          torch.argmin(torch.where(isn, math.inf, jcr), 1))
        wdu = self.cr_wspd[icr]
        phid = torch.where(has_co, phir, 0.0)
        cr_ok = ~torch.isnan(s0_cr) & ~torch.isnan(dsig_cr)
        nan = math.nan
        co = torch.complex(torch.where(guard, nan, wspd * torch.cos(phir)).float(),
                           torch.where(guard, 0.0, wspd * torch.sin(phir)).float())
        du = torch.complex(torch.where(guard | ~cr_ok, nan, wdu * torch.cos(phid)).float(),
                           torch.where(guard, 0.0, torch.where(cr_ok, wdu * torch.sin(phid),
                                                               nan)).float())
        if merged:
            take = (torch.abs(co) < MERGE_BELOW) | (torch.abs(du) < MERGE_BELOW)
            du = torch.where(take, co, du)
        return co, du


def sample_inputs_f64(x):
    """The sampled inputs as the judge takes them: incidence in float32,
    the rest in float64 (numpy or tensors in)."""
    out = {}
    for k, v in x.items():
        v = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        out[k] = v.float() if k == "inc" else v.double()
    return out
