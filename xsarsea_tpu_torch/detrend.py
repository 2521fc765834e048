"""sigma0 detrending ("roughness" / nice display) and the sarwing OWI reader
(counterpart of ``xsarsea_tpu.detrend``).

`sigma0_detrend` divides out the incidence-angle trend predicted by a GMF at
a fixed (wind speed, direction), following the reference algorithm
(``detrend.py:8-68``): one GMF evaluation per column of the first image
line, normalized by its mean, broadcast-divided into sigma0.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.dimarray import DimArray, is_chunked
from xsarsea_tpu_torch.interop import to_dataset, xarray_io
from xsarsea_tpu_torch.models.base import get_model
from xsarsea_tpu_torch.utils import as_tensor, compute_device, logger, timing, to_host

__all__ = ["sigma0_detrend", "read_sarwing_owi"]

_BLOCK_ELEMS = 1 << 22  # elements of a chunked sigma0 divided at a time


@xarray_io
@timing(logger=logger.info)
def sigma0_detrend(sigma0, inc_angle, wind_speed_gmf=10.0, wind_dir_gmf=45.0,
                   model="gmf_cmod5n", device="cuda"):
    """Compute detrended sigma0 from linear sigma0 and incidence (deg).

    Parameters mirror the reference ``sigma0_detrend`` (detrend.py:8-68);
    `sigma0` and `inc_angle` may be DimArrays with ('line', 'sample') dims
    or plain 2-D arrays (line, sample). The divide runs on ``device``, or
    where a tensor input already lives; numpy (and chunked) sigma0 gives a
    numpy result, a tensor a tensor. A chunked sigma0 is divided row block
    by row block into a preallocated host array, so host memory stays
    O(output + block).
    """
    model = get_model(model)

    wspd = np.asarray(wind_speed_gmf, dtype=np.float64).reshape(-1)
    phi = np.asarray(wind_dir_gmf, dtype=np.float64).reshape(-1)
    if wspd.size != 1 or phi.size != 1:
        raise ValueError("wind_speed_gmf and wind_dir_gmf must be scalars (size 1)")

    raw_s0 = sigma0.data if isinstance(sigma0, DimArray) else sigma0
    raw_inc = inc_angle.data if isinstance(inc_angle, DimArray) else inc_angle
    if not (isinstance(raw_s0, torch.Tensor) or is_chunked(raw_s0)):
        raw_s0 = np.asarray(raw_s0)
    device = compute_device(device, raw_s0, raw_inc)

    # only the first line of incidence feeds the GMF (detrend.py:55); a
    # chunked incidence is asked for that one row
    if is_chunked(raw_inc):
        inc_row = np.asarray(raw_inc[0:1])[0]
    else:
        inc_row = raw_inc[0] if isinstance(raw_inc, torch.Tensor) else np.asarray(raw_inc)[0]

    if hasattr(model, "_eval_broadcast"):  # analytic: on the device, in incidence's dtype
        inc_row = as_tensor(inc_row, device)
        sample = model._eval_broadcast(inc_row, *(torch.tensor(v[0], dtype=inc_row.dtype,
                                                               device=device)
                                                  for v in (wspd, phi)))
        ratio = sample / torch.nanmean(sample)
    else:  # tabulated: through the model's LUT interp, on the host
        sample = model(to_host(as_tensor(inc_row, "cpu")), wspd, phi)
        sample_v = np.squeeze(np.asarray(sample))
        ratio = torch.as_tensor(sample_v / np.nanmean(sample_v), device=device)

    if is_chunked(raw_s0):
        shape = tuple(int(s) for s in raw_s0.shape)
        out_dtype = torch.empty(0, dtype=ratio.dtype).numpy().dtype
        detrended = np.empty(shape, dtype=np.result_type(raw_s0.dtype, out_dtype))
        rows = max(1, _BLOCK_ELEMS // max(1, shape[1]))
        for r0 in range(0, shape[0], rows):
            block = as_tensor(np.asarray(raw_s0[r0:r0 + rows]), device)
            to_host(block / ratio[None, :], out=detrended[r0:r0 + rows])
    else:
        detrended = as_tensor(raw_s0, device) / ratio[None, :]
        if not isinstance(raw_s0, torch.Tensor):
            detrended = to_host(detrended)

    if isinstance(sigma0, DimArray):
        out = sigma0.copy(data=detrended)
        return out.assign_attrs(comment=f"detrended with model {model.name}")
    return detrended


def read_sarwing_owi(owi_file):
    """Read a sarwing OWI netCDF file (needs ``h5py``).

    Counterpart of the reference ``read_sarwing_owi`` (detrend.py:71-93):
    with xarray installed, returns an ``xr.Dataset`` (reference parity);
    otherwise a plain ``dict`` keyed by variable name. Each variable is
    2-D over ('line', 'sample'), with the ``owiInversionTables_UV`` group
    merged in and line/sample coordinates assigned.
    """
    import h5py

    out = {}

    def load_group(grp):
        for key, dset in grp.items():
            if not hasattr(dset, "shape") or dset.ndim != 2:
                continue
            if key in ("owiCalConstObsi", "owiCalConstInci"):
                continue
            data = np.asarray(dset)
            out[key] = DimArray(data, dims=("line", "sample"),
                                coords={"line": np.arange(data.shape[0]),
                                        "sample": np.arange(data.shape[1])}, name=key)

    with h5py.File(owi_file, "r") as f:
        load_group(f)
        if "owiInversionTables_UV" in f:
            load_group(f["owiInversionTables_UV"])

    try:  # reference parity: an xr.Dataset when xarray is available
        import xarray as xr
    except ImportError:
        return out
    ds = to_dataset(out, xr.DataArray)
    return ds if ds is not None else out
