"""Out-of-core inputs through the port, against the JAX package, on the CPU.

Counterparts of the chunked-input cases of tests/test_streaming.py, with its
``LazyRows`` stand-in for a dask or zarr array (rows made on demand, the
largest single request counted): lazy GMF evaluation, ``sigma0_detrend`` on a
chunked scene, ``_any_valid``'s row-block scan, and a chunked payload inside
a DimArray. Tolerances: a lazy result is bit-equal to the port's eager one
on the same inputs (the same torch operations on a row block as on the whole
array, in float64); against the JAX package the GMF values agree to rtol
1e-12 and the detrended scene to rtol 1e-10 (torch's and XLA's ``exp``,
``pow`` and ``cos`` differ in the last bits); the inversion's winds equal
the JAX ``exact`` mode's up to the phi = +-180 deg tie and 1e-13 relative.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu.detrend import sigma0_detrend as jax_detrend
from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.windspeed import inversion as jinv
from xsarsea_tpu_torch.detrend import sigma0_detrend
from xsarsea_tpu_torch.dimarray import DimArray, is_chunked
from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.windspeed.inversion import _any_valid, invert_from_model

from test_streaming import LazyRows, _lazy_scene
from test_torch_inversion import F64_TRIG, assert_parity

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = ("gmf_cmod5n", "gmf_s1_v2")
KW = dict(inc_step=0.4, wspd_step=0.4, phi_step=2.5)


def _lazy(a):
    return LazyRows(lambda i, j: a[i:j], a.shape, dtype=a.dtype)


def test_lazy_direct_gmf_evaluation():
    m = get_model("gmf_cmod5n")
    ny, nx = 64, 80
    rng = np.random.default_rng(7)
    inc = rng.uniform(18, 47, (ny, nx))
    wspd = rng.uniform(0.5, 45, (ny, nx))
    phi = rng.uniform(0, 360, (ny, nx))
    l_inc, l_wspd = _lazy(inc), _lazy(wspd)

    out = m(l_inc, l_wspd, phi)
    assert is_chunked(out)           # the result is lazy, not materialized
    assert out.shape == (ny, nx) and out.ndim == 2 and out.dtype == np.float64
    assert sum(out.chunks[0]) == ny and out.chunks[1] == (nx,)
    assert l_inc.max_request == 0    # nothing touched yet

    eager = m(inc, wspd, phi).numpy()
    blk = out[3:9]                   # a block pull evaluates only that band
    assert isinstance(blk, np.ndarray)
    np.testing.assert_array_equal(blk, eager[3:9])
    assert 0 < l_inc.max_request <= 6 * nx
    np.testing.assert_array_equal(np.asarray(out), eager)
    np.testing.assert_allclose(eager, np.asarray(jax_model("gmf_cmod5n")(inc, wspd, phi)),
                               rtol=1e-12)

    # small broadcast operand: 1-row chunked phi against full-shape others
    l_phi = LazyRows(lambda a, b: phi[:1][a:b], (1, nx))
    eager2 = m(inc, wspd, np.broadcast_to(phi[:1], (ny, nx))).numpy()
    np.testing.assert_array_equal(np.asarray(m(l_inc, l_wspd, l_phi)), eager2)
    # a tensor beside a chunked input decides dtype and device
    out32 = m(l_inc, torch.as_tensor(wspd, dtype=torch.float32), phi)
    assert out32.dtype == np.float32 and out32[0:2].dtype == np.float32

    # DimArray wrapping keeps the payload lazy
    res = m(DimArray(_lazy(inc), dims=("line", "sample")), wspd, phi)
    assert isinstance(res, DimArray) and is_chunked(res.data)
    assert res.attrs == {"units": "linear"} and res.dims == ("line", "sample")

    # streaming consumers can slice it; anything else is rejected
    with pytest.raises(IndexError, match="strided"):
        out[::2]
    with pytest.raises(IndexError, match="first-axis"):
        out[:, 3]


def test_lazy_gmf_phi_independent_broadcast_shape():
    m = get_model("gmf_s1_v2")  # crosspol: ignores phi
    ny, nx = 48, 56
    rng = np.random.default_rng(11)
    inc_row = rng.uniform(18, 47, (1, nx))
    wspd_row = rng.uniform(0.5, 45, (1, nx))
    phi = rng.uniform(0, 360, (ny, nx))

    eager = m(inc_row, wspd_row, phi, broadcast=True).numpy()
    assert eager.shape == (ny, nx)  # eager broadcasts over phi
    out = m(_lazy(inc_row), _lazy(wspd_row), phi)
    assert is_chunked(out) and out.shape == (ny, nx)  # lazy must agree
    np.testing.assert_array_equal(np.asarray(out), eager)
    # chunked phi as the only lazy input: stays lazy, same shape rule
    out2 = m(inc_row, wspd_row, _lazy(phi))
    assert is_chunked(out2) and out2.shape == (ny, nx)
    np.testing.assert_array_equal(np.asarray(out2), eager)
    ref = np.asarray(jax_model("gmf_s1_v2")(inc_row, wspd_row, phi, broadcast=True))
    np.testing.assert_allclose(eager, ref, rtol=1e-12)


def test_lazy_detrend_matches_eager():
    ny, nx = 60, 80
    rng = np.random.default_rng(3)
    inc = np.linspace(18.0, 45.0, nx)[None, :].repeat(ny, axis=0)
    s0 = rng.uniform(0.001, 0.2, size=(ny, nx))

    ref = sigma0_detrend(s0, inc, device="cpu")
    lazy_s0, lazy_inc = _lazy(s0), _lazy(inc)
    got = sigma0_detrend(lazy_s0, lazy_inc, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    assert lazy_inc.max_request == nx  # only the first incidence row was ever pulled
    assert lazy_s0.max_request <= 1 << 22
    np.testing.assert_allclose(ref, np.asarray(jax_detrend(s0, inc)), rtol=1e-10)
    # several row blocks
    import xsarsea_tpu_torch.detrend as D
    lazy_s0 = _lazy(s0)
    old, D._BLOCK_ELEMS = D._BLOCK_ELEMS, 7 * nx
    try:
        np.testing.assert_array_equal(sigma0_detrend(lazy_s0, inc, device="cpu"), ref)
    finally:
        D._BLOCK_ELEMS = old
    assert lazy_s0.max_request == 7 * nx


def test_lazy_any_valid_early_exit():
    probe = LazyRows(lambda a, b: np.ones((b - a, 64), complex), (1 << 17, 64),
                     dtype=np.complex128)
    assert _any_valid(probe)
    assert 0 < probe.max_request <= (1 << 22)  # one row block of 2**23 elements, then out
    all_nan = LazyRows(lambda a, b: np.full((b - a, 64), np.nan), (128, 64))
    assert not _any_valid(all_nan)
    assert _any_valid(DimArray(probe, dims=("line", "sample")))
    assert _any_valid(np.ones(3)) and not _any_valid(np.full(3, np.nan)) and not _any_valid(None)
    assert _any_valid(torch.ones(3)) and _any_valid(2.0) and not _any_valid(float("nan"))


def test_lazy_all_nan_ancillary_rejected():
    ny, nx = 8, 16
    inc = np.full((ny, nx), 30.0)
    s0 = np.full((ny, nx), 0.01)
    anc_nan = LazyRows(lambda a, b: np.full((b - a, nx), np.nan, complex), (ny, nx),
                       dtype=np.complex128)
    with pytest.raises(ValueError, match="ancillary_wind"):
        with pytest.warns(UserWarning, match="pol"):
            invert_from_model(_lazy(inc), _lazy(s0), ancillary_wind=anc_nan,
                              model="gmf_cmod5n", mode="exact", device="cpu", **KW)


def test_lazy_input_inside_dimarray_stays_lazy():
    ny, nx = 64, 70
    (inc, s0_co, s0_cr, dsig_cr, anc), lazy = _lazy_scene(ny, nx)
    dims = ("line", "sample")
    da_s0 = DimArray(lazy["s0_co"], dims=dims, coords={"pol": np.asarray("VV")})
    assert da_s0.data is lazy["s0_co"]  # the constructor did not coerce

    kw = dict(ancillary_wind=anc, dsig_cr=dsig_cr, model=MODEL, mode="exact", **KW)
    co_ref, dual_ref = invert_from_model(inc, s0_co, s0_cr, device="cpu", **kw)
    co_lz, dual_lz = invert_from_model(
        DimArray(lazy["inc"], dims=dims), da_s0, lazy["s0_cr"], ancillary_wind=lazy["anc"],
        dsig_cr=lazy["dsig_cr"], model=MODEL, mode="exact", piece_size=1024, device="cpu", **KW)
    assert isinstance(co_lz, DimArray) and co_lz.dims == dims
    np.testing.assert_array_equal(co_lz.values, co_ref)
    np.testing.assert_array_equal(dual_lz.values, dual_ref)
    for name, arr in lazy.items():
        assert 0 < arr.max_request <= 1024 + 2 * nx, (name, arr.max_request)
    jco, jdual = jinv.invert_from_model(inc, s0_co, s0_cr, device_db=False, **kw)
    assert_parity(co_ref.reshape(-1), np.asarray(jco).reshape(-1), F64_TRIG)
    assert_parity(dual_ref.reshape(-1), np.asarray(jdual).reshape(-1), F64_TRIG)
