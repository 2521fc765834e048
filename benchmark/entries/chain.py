"""Scenes as an L1 product gives them to xsarsea's L1 example, in host
memory: float64 incidence, linear float32 sigma0 VV and VH, complex128
ancillary wind and the VH channel's raw linear NESZ in float32, each of the
scene's (line, sample) shape. One call of ``invert_from_model`` with
``dsig_cr=SCHEME, nesz_cr=<NESZ>`` does the example's three: the NESZ
flattened by a line fit per row, ``dsig_cr`` from the scheme, the dual-pol
inversion; the winds come back as host arrays, dual-pol merged.

The NESZ field is the traffic file's ``nesz_cr_field`` around its
``nesz_cr_db``, drawn on the scene's device from a generator seeded by the
scene's own values (so the same seed gives the same field). The judge's
``dsig_cr`` is the plain reference's chain (``reference/prep.py``) over the
whole scene, in float64 on the scene's device, from the arrays the program
is handed; it is kept beside them and never handed to the program.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path

import torch

from benchmark.entries import host
from benchmark.entries.host import received, take  # noqa: F401  (the same as from host)
from benchmark.reference import prep

MERGED = True
SCHEME = "gmf_s1_v2"  # the configuration's dsig_cr scheme
TRAFFIC = Path(__file__).resolve().parents[1] / "traffic" / "iw_100m_l1_chain.json"


def field_generator(scene):
    """A generator on the scene's device, seeded by the scene's first
    ancillary values (drawn from the run's seed)."""
    head = scene["anc_re"][:16].double().cpu().numpy().tobytes()
    gen = torch.Generator(device=scene["inc"].device)
    gen.manual_seed(int.from_bytes(hashlib.sha256(head).digest()[:8], "little"))
    return gen


def nesz_field(scene, traffic, gen):
    """The scene's raw VH NESZ, linear float64, (line, sample)."""
    f = traffic["nesz_cr_field"]
    lines, samples = scene["shape"]
    f64 = dict(dtype=torch.float64, device=scene["inc"].device)
    offsets = torch.tensor(f["subswath_offsets_db"], **f64)
    third = torch.arange(samples, device=offsets.device) * offsets.shape[0] // samples
    db = traffic["nesz_cr_db"] + f["slope_db_per_deg"] * (scene["inc"].view(lines, samples)
                                                          - f["inc0_deg"]) \
        + offsets[third] + f["noise_db"] * torch.randn((lines, samples), generator=gen, **f64)
    nesz = 10.0 ** (db / 10.0)
    nan = torch.randperm(lines * samples, generator=gen, device=offsets.device)
    nesz.view(-1)[nan[:f["nan_samples"]]] = math.nan
    return nesz


def place(scene):
    traffic = json.loads(TRAFFIC.read_text())
    shape = scene["shape"]
    nesz = nesz_field(scene, traffic, field_generator(scene)).to(torch.float32)
    s0_cr = scene["s0_cr"].to(torch.float32)
    # the reference's weights from the values the program is handed, for the judge
    weights = prep.dsig_from_nesz(SCHEME, scene["inc"].view(shape), s0_cr.double().view(shape),
                                  nesz.double())
    placed = host.place(scene)
    placed["dsig_cr"] = weights.cpu().numpy()  # float64: not handed to the program
    placed["nesz_cr"] = nesz.cpu().numpy()
    return placed


def invert(program, placed):
    return program.invert_from_model(
        placed["inc"], placed["s0_co"], placed["s0_cr"], ancillary_wind=placed["anc"],
        dsig_co=program.dsig_co, dsig_cr=SCHEME, nesz_cr=placed["nesz_cr"],
        model=program.models, dtype=program.dtype, mode=program.mode, device=program.device)
