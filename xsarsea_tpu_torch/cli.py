"""Command-line interface of the port: ``xsarsea-tpu-torch``.

Counterpart of ``xsarsea_tpu.cli`` (the reference CLI
``xsarsea_cli.py``): ``models-to-nc`` exports every registered non-netCDF
model to netCDF LUT files; ``list`` prints the registry; ``models-to-packed``
writes the packed XSTL1 LUT caches; ``invert`` inverts a scene file into
wind, the serving entry point.

The port's device rule adds one argument to ``invert``: ``--device`` (default
``cuda``; without a card that raises, ``--device cpu`` computes on the host).
``--mode`` takes the port's names (``auto``, ``exact``, ``fused``,
``fused_exact``); the JAX package's ``pallas`` names are refused with their
counterpart named. argparse-based, as the JAX package's.
"""

from __future__ import annotations

import argparse
import os
import sys

# the JAX package's inversion modes and the port's counterparts
_JAX_MODES = {"pallas": "fused", "pallas_exact": "fused_exact", "pallas_interpret": "fused"}


def _register_from_args(args):
    from xsarsea_tpu_torch.models import register_luts

    if getattr(args, "nc_lut_dir", None) or getattr(args, "cmod7_dir", None):
        register_luts(topdir=args.nc_lut_dir, topdir_cmod7=args.cmod7_dir)


def _models_to(export_dir, fmt, args):
    from xsarsea_tpu_torch.io.lut_io import write_packed_lut
    from xsarsea_tpu_torch.models import available_models
    from xsarsea_tpu_torch.models.base import LutModel
    from xsarsea_tpu_torch.models.nc_lut import NcLutModel

    _register_from_args(args)
    os.makedirs(export_dir, exist_ok=True)
    prefix = LutModel._name_prefix
    for row in available_models().values():
        model = row["model"]
        if isinstance(model, NcLutModel):
            print(f"Skipping {model.name} ({model.path})")
            continue
        try:
            if fmt == "nc":
                outfile = os.path.join(export_dir, f"{prefix}{model.name}.nc")
                model.to_netcdf(outfile)
            else:
                outfile = os.path.join(export_dir, f"{prefix}{model.name}.xstl")
                lut = model.to_lut(units="dB")
                write_packed_lut(outfile, lut, lut.attrs)
            print(f"Wrote {outfile}")
        except Exception as e:  # noqa: BLE001 - one model's failure must not stop the export
            print(f"Error processing {model.name} : {e}")


def cmd_models_to_nc(args):
    _models_to(args.export_dir, "nc", args)


def cmd_models_to_packed(args):
    _models_to(args.export_dir, "packed", args)


def _table(rows, columns):
    """``rows`` ({index: {column: value}}) as an aligned text table."""
    header = [""] + list(columns)
    body = [[str(k)] + ["None" if r[c] is None else str(r[c]) for c in columns]
            for k, r in rows.items()]
    widths = [max(len(line[i]) for line in [header] + body) for i in range(len(header))]
    fmt = [str.ljust] + [str.rjust] * len(columns)
    return "\n".join("  ".join(f(cell, w) for f, cell, w in zip(fmt, line, widths)).rstrip()
                     for line in [header] + body)


def cmd_list(args):
    from xsarsea_tpu_torch.models import available_models

    _register_from_args(args)
    print(_table(available_models(pol=args.pol), ("alias", "pol")))


def _load_scene(path):
    """Arrays of an ``.npz``, or of a directory of per-key ``.npy`` files,
    each memory-mapped (a scene larger than memory streams through the
    inversion's pieces with O(piece) host memory)."""
    import numpy as np

    if not os.path.isdir(path):
        return np.load(path)
    return {f[:-4]: np.load(os.path.join(path, f), mmap_mode="r")
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


def cmd_invert(args):
    """Batch wind inversion: a scene file in, a wind field out.

    Reads inc/sigma0[/sigma0_dual/ancillary_wind] from an ``.npz`` or a
    directory of ``.npy`` files (memory-mapped; ``scripts/demo_full_scene.py``
    runs that layout at 10^8 px) and writes complex wind to an ``.npz``.
    """
    import numpy as np

    from xsarsea_tpu_torch.utils import resolve_device
    from xsarsea_tpu_torch.windspeed import invert_from_model

    if args.mode in _JAX_MODES:
        raise SystemExit(f"--mode {args.mode} is the JAX package's name: its counterpart here "
                         f"is --mode {_JAX_MODES[args.mode]}")
    device = resolve_device(args.device)
    _register_from_args(args)
    scene = _load_scene(args.scene)
    missing = [k for k in ("inc", "sigma0") if k not in scene]
    if missing:
        raise SystemExit(f"{args.scene}: missing required arrays {missing} "
                         f"(found {list(scene.keys())})")
    models = tuple(m.strip() for m in args.model.split(","))
    dual = scene["sigma0_dual"] if "sigma0_dual" in scene else None
    anc = scene["ancillary_wind"] if "ancillary_wind" in scene else None
    # scene channels and model count must agree: never silently drop one
    if dual is None and len(models) != 1:
        raise SystemExit(
            f"--model names {len(models)} models {models} but the scene has no 'sigma0_dual' "
            f"array: pass exactly one model (found {sorted(scene.keys())})")
    if dual is not None and len(models) != 2:
        raise SystemExit("scene has a 'sigma0_dual' array: pass two models "
                         "(--model co_model,cr_model) or remove the dual channel")
    if dual is not None:
        wind_co, wind_dual = invert_from_model(
            scene["inc"], scene["sigma0"], dual, ancillary_wind=anc, dsig_cr=args.dsig_cr,
            model=models, mode=args.mode, device=device)
        np.savez(args.out, wind_co=wind_co, wind_dual=wind_dual)
        speeds = np.abs(wind_dual)
    else:
        wind = invert_from_model(
            scene["inc"], scene["sigma0"], ancillary_wind=anc, dsig_cr=args.dsig_cr,
            model=models[0], mode=args.mode, device=device)
        np.savez(args.out, wind=wind)
        speeds = np.abs(wind)
    valid = np.isfinite(speeds)
    if valid.any():
        summary = f"{valid.mean():.1%} valid, mean speed {np.nanmean(speeds[valid]):.2f} m/s"
    else:
        summary = "0% valid — no finite retrievals"
    print(f"inverted {speeds.size} px with {'+'.join(models)} -> {args.out} ({summary})")


def main(argv=None):
    p = argparse.ArgumentParser(prog="xsarsea-tpu-torch",
                                description="SAR ocean analysis toolkit (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--nc-lut-dir", default=None,
                        help="directory of nc_lut_*.nc LUTs to register")
    common.add_argument("--cmod7-dir", default=None,
                        help="CMOD7 binary LUT directory to register")

    p_nc = sub.add_parser("models-to-nc", parents=[common],
                          help="export registered models to netCDF LUTs")
    p_nc.add_argument("export_dir", help="destination directory")
    p_nc.set_defaults(func=cmd_models_to_nc)

    p_pk = sub.add_parser("models-to-packed", parents=[common],
                          help="export registered models to packed LUT caches")
    p_pk.add_argument("export_dir", help="destination directory")
    p_pk.set_defaults(func=cmd_models_to_packed)

    p_ls = sub.add_parser("list", parents=[common], help="list registered models")
    p_ls.add_argument("--pol", default=None, help="filter by polarization")
    p_ls.set_defaults(func=cmd_list)

    p_inv = sub.add_parser(
        "invert", parents=[common],
        help="invert a scene .npz (inc, sigma0[, sigma0_dual, ancillary_wind]) into wind")
    p_inv.add_argument("scene", help=".npz with inc/sigma0[/sigma0_dual/ancillary_wind] "
                                     "arrays, or a directory of such .npy files")
    p_inv.add_argument("out", help="output .npz path")
    p_inv.add_argument("--model", required=True,
                       help="model name, or 'co_model,cr_model' for dual-pol")
    p_inv.add_argument("--mode", default="auto",
                       help="inversion mode (auto/exact/fused/fused_exact)")
    p_inv.add_argument("--dsig-cr", type=float, default=0.1)
    p_inv.add_argument("--device", default="cuda",
                       help="where to invert (default cuda; 'cpu' computes on the host)")
    p_inv.set_defaults(func=cmd_invert)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
