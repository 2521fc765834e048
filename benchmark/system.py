"""The system under test: the port's tables and entry points for one
configuration. The only module of the benchmark that imports the program."""

from __future__ import annotations

import gzip
import os
import shutil
from pathlib import Path
from types import SimpleNamespace

import torch


def _unpacked(root, rel):
    """A gzipped raw file unpacked once per checkout into ``build/benchmark``
    (a fixed path, so that later runs find it), and the directory it is in."""
    src = Path(root) / rel
    dst = Path(root) / "build" / "benchmark" / src.parent.name / src.name[:-len(".gz")]
    if not dst.exists():
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
        with gzip.open(src, "rb") as f_in, open(tmp, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
        os.replace(tmp, dst)
    return dst.parent


def build(config, root, device):
    """Register the configuration's LUT files with the port and prepare its
    tables (the program's set-up)."""
    from xsarsea_tpu_torch import windspeed as ws

    for reg in config["register"]:
        if reg["kind"] == "cmod7":
            ws.register_cmod7(str(_unpacked(root, reg["file"])))
        elif reg["kind"] == "sarwing_pickle":
            ws.register_pickle_luts(str(Path(root) / reg["dir"]))
        else:
            raise ValueError(f"unknown LUT registration {reg['kind']!r}")
    dtype = getattr(torch, config["dtype"])
    tables = ws.prepare_tables(*config["models"], dtype=dtype)
    return SimpleNamespace(tables=tables, models=tuple(config["models"]), dtype=dtype,
                           mode=config["mode"], dsig_co=config["dsig_co"],
                           device=torch.device(device), invert_pixels=ws.invert_pixels,
                           invert_from_model=ws.invert_from_model)
