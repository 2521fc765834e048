"""Scenes as an L1 product gives them, in host memory: float64 incidence,
linear float32 sigma0, complex128 ancillary wind and a float32 ``dsig_cr``,
each of the scene's (line, sample) shape, through ``invert_from_model``
with ``model=(copol, crosspol)``; the winds come back as host arrays,
dual-pol merged."""

from __future__ import annotations

import numpy as np
import torch

MERGED = True


def place(scene):
    shape = scene["shape"]

    def host(t, dtype):
        return t.to(dtype).reshape(shape).cpu().numpy()

    return {"inc": host(scene["inc"], torch.float64),
            "s0_co": host(scene["s0_co"], torch.float32),
            "s0_cr": host(scene["s0_cr"], torch.float32),
            "dsig_cr": host(scene["dsig_cr"], torch.float32),
            "anc": host(torch.complex(scene["anc_re"], scene["anc_im"]), torch.complex128)}


def invert(program, placed):
    return program.invert_from_model(
        placed["inc"], placed["s0_co"], placed["s0_cr"], ancillary_wind=placed["anc"],
        dsig_co=program.dsig_co, dsig_cr=placed["dsig_cr"], model=program.models,
        dtype=program.dtype, mode=program.mode, device=program.device)


def take(winds, idx):
    idx = idx.cpu().numpy()
    return (torch.from_numpy(np.take(winds[0].reshape(-1), idx)),
            torch.from_numpy(np.take(winds[1].reshape(-1), idx)))


def received(placed, idx):
    idx = idx.cpu().numpy()

    def flat(a):
        return torch.from_numpy(np.take(a.reshape(-1), idx))

    s0 = {k: flat(placed[k]).double() for k in ("s0_co", "s0_cr")}
    anc = flat(placed["anc"])
    return {"inc": flat(placed["inc"]).float(),
            "s0_co_db": 10.0 * torch.log10(s0["s0_co"] + 1e-15),
            "s0_cr_db": 10.0 * torch.log10(s0["s0_cr"] + 1e-15),
            "dsig_cr": flat(placed["dsig_cr"]),
            "anc_re": anc.real.float(), "anc_im": anc.imag.float()}
