"""Scenes read from files on the node, as archive reprocessing reads L1
products: each scene written once with ``np.save`` (float32 incidence on the
full grid, float32 linear sigma0 VV and VH, a float32 ``dsig_cr``, a complex64
ancillary wind: 24 bytes a pixel) and synced to disk. Only its directory is
kept: every call opens the files anew with ``np.load(..., mmap_mode="r")``, as
a chain opens each product, and hands them to ``invert_from_model`` with
``model=(copol, crosspol)``; the program maps and reads each piece's pages
from the files (warm, through the page cache), the maps are dropped when the
call returns, and the winds come back as host arrays, dual-pol merged.

The files live in a fresh directory a scene under the checkout's
``build/benchmark/scenes/`` (not ``TMPDIR``, which may be memory). A scene's
directory is removed when its placed scene is dropped, and whatever is left
when the process ends, also after a failure.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from pathlib import Path

import numpy as np
import torch

from benchmark.entries import host
from benchmark.entries.host import take  # noqa: F401  (the same as from host)

MERGED = True
SCENES = Path(__file__).resolve().parents[2] / "build" / "benchmark" / "scenes"
FILES = (("inc", torch.float32), ("s0_co", torch.float32), ("s0_cr", torch.float32),
         ("dsig_cr", torch.float32), ("anc", torch.complex64))


class Placed:
    """A scene written to disk: ``path`` is its directory of ``.npy`` files."""

    def __init__(self, path):
        self.path = path
        weakref.finalize(self, shutil.rmtree, path, ignore_errors=True)


def _write(path, array):
    with open(path, "wb") as f:
        np.save(f, array)
        f.flush()
        os.fsync(f.fileno())  # no writeback left to overlap the window


def place(scene):
    SCENES.mkdir(parents=True, exist_ok=True)
    placed = Placed(Path(tempfile.mkdtemp(prefix="scene-", dir=SCENES)))
    shape = scene["shape"]
    for name, dtype in FILES:
        t = torch.complex(scene["anc_re"], scene["anc_im"]) if name == "anc" else scene[name]
        _write(placed.path / f"{name}.npy", t.to(dtype).reshape(shape).cpu().numpy())
    return placed


def open_scene(placed):
    """The scene's files, each memory-mapped anew: the arrays a call reads."""
    return {name: np.load(placed.path / f"{name}.npy", mmap_mode="r") for name, _ in FILES}


def invert(program, placed):
    a = open_scene(placed)  # mapped for this call alone, unmapped when it returns
    return program.invert_from_model(
        a["inc"], a["s0_co"], a["s0_cr"], ancillary_wind=a["anc"],
        dsig_co=program.dsig_co, dsig_cr=a["dsig_cr"], model=program.models,
        dtype=program.dtype, mode=program.mode, device=program.device)


def received(placed, idx):
    return host.received(open_scene(placed), idx)
