"""Scenes already on the card, winds left there: ``invert_pixels`` on flat
float32 tensors (sigma0 in dB, complex64 ancillary wind) with
``device_output=True``, as a chain that calibrates on the card calls it."""

from __future__ import annotations

import torch

MERGED = False


def place(scene):
    f32 = torch.float32
    return {"inc": scene["inc"].to(f32),
            "s0_co_db": (10.0 * torch.log10(scene["s0_co"] + 1e-15)).to(f32),
            "s0_cr_db": (10.0 * torch.log10(scene["s0_cr"] + 1e-15)).to(f32),
            "dsig_cr": scene["dsig_cr"].to(f32),
            "anc": torch.complex(scene["anc_re"].to(f32), scene["anc_im"].to(f32))}


def invert(program, placed):
    co, dual = program.invert_pixels(
        program.tables, placed["inc"], placed["s0_co_db"], placed["s0_cr_db"],
        placed["dsig_cr"], placed["anc"], dsig_co=program.dsig_co, mode=program.mode,
        device=program.device, device_output=True)
    if co.is_cuda:
        torch.cuda.synchronize(co.device)
    return co, dual


def take(winds, idx):
    return winds[0][idx], winds[1][idx]


def received(placed, idx):
    anc = placed["anc"][idx]
    return {"inc": placed["inc"][idx], "s0_co_db": placed["s0_co_db"][idx],
            "s0_cr_db": placed["s0_cr_db"][idx], "dsig_cr": placed["dsig_cr"][idx],
            "anc_re": anc.real, "anc_im": anc.imag}
