"""The port's gradient classes and post-processing against the JAX package,
on the CPU, in float64.

The non-plot cases of tests/test_gradients.py and the chunked cases of
tests/test_streaming.py, with the JAX classes as the oracle. Tolerances:
histograms rtol 1e-9 with atol 1e-12 (sums of exact products in an
unspecified order; see tests/test_torch_gradients_core.py), ``used_ratio``
rtol 1e-14 (the port divides the count by the window's pixels, XLA multiplies
by the reciprocal of that constant: an ulp), every coordinate bit for bit, the
port's own paths among themselves bit for bit, ``filtering_parameters`` rtol 1e-9 with
atol 1e-12 (a difference of squares under a square root), ``circ_smooth``
rtol 1e-12. ``xarray`` is installed nowhere: the DataArray bridge is driven
with tests/_xr_stub.py.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu import gradients as JG
from xsarsea_tpu.dimarray import DimArray as JDimArray
import xsarsea_tpu_torch
from xsarsea_tpu_torch import gradients as TG
from xsarsea_tpu_torch.dimarray import DimArray, DimDataset
from xsarsea_tpu_torch.gradients import Gradients, Gradients2D

import _xr_stub
from test_streaming import Lazy3D, LazyRows
from test_torch_gradients_core import streak_image

torch.set_num_threads(min(2, torch.get_num_threads()))

HIST_TOL = dict(rtol=1e-9, atol=1e-12)


def _pair(data, **kw):
    """The same labelled array for the JAX package and for the port."""
    return JDimArray(data, **kw), DimArray(data, **kw)


def _one_pol(ny=192, nx=160, step=1.0, **kw):
    img = streak_image(ny, nx, angle_deg=25.0, **kw)
    return dict(data=img[None], dims=("pol", "line", "sample"),
                coords={"pol": np.array(["VV"]), "line": np.arange(float(ny)) * step,
                        "sample": np.arange(float(nx)) * step})


def assert_same_histogram(got, ref):
    """A port histogram dataset against a JAX one: dims, coords, values."""
    for name in ("weight", "used_ratio"):
        g, r = got[name], ref[name]
        assert g.dims == r.dims and g.shape == r.shape
        for k in r.coords:
            np.testing.assert_array_equal(g.coords[k], r.coords[k], err_msg=k)
    np.testing.assert_allclose(got["weight"].values, np.asarray(ref["weight"].data), **HIST_TOL)
    np.testing.assert_allclose(got["used_ratio"].values, np.asarray(ref["used_ratio"].data),
                               rtol=1e-14, atol=0)


def test_gradients2d_end_to_end():
    assert xsarsea_tpu_torch.gradients is TG and "gradients" in xsarsea_tpu_torch.__all__
    assert set(JG.__all__) <= set(TG.__all__)  # PlotGradients included
    img = streak_image(400, 400, angle_deg=25.0)
    g = Gradients2D(img, window_size=100, window_step=1, device="cpu")
    hist = g.histogram
    assert isinstance(hist, DimDataset) and set(hist.variables) == {"weight", "used_ratio"}
    w = hist["weight"]
    assert w.dims == ("line", "sample", "angles") and w.sizes["angles"] == 72
    assert isinstance(w.data, torch.Tensor)  # results stay on the compute device
    assert (hist["used_ratio"].values <= 1.0).all()
    assert_same_histogram(hist, JG.Gradients2D(img, window_size=100, window_step=1).histogram)
    assert w.values[1:-1, 1:-1].argmax(axis=-1).std() < 3.0  # a coherent direction field
    assert g.histogram is hist  # cached: a second read does not run the pipeline again
    # the properties on the way
    np.testing.assert_allclose(g.i2.values, np.asarray(JG.Gradients2D(img).i2.data), rtol=1e-12)
    np.testing.assert_allclose(g.ampl.values, np.sqrt(g.i2.values), rtol=1e-15)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Gradients2D(img, window_step=1, windows_at={"line": [0], "sample": [0]}, device="cpu")


def test_window_stepping_noninteger_coord_ratio():
    ny, nx = 230, 212
    img = streak_image(ny, nx, angle_deg=40.0)
    kw = dict(dims=("line", "sample"),
              coords={"line": np.arange(ny) * 7.3 + 3.1, "sample": np.arange(nx) * 9.1})
    jda, da = _pair(img, **kw)
    g = Gradients2D(da, window_size=150.0, window_step=1, device="cpu")
    ref = JG.Gradients2D(jda, window_size=150.0, window_step=1)
    for d in ("line", "sample"):
        np.testing.assert_array_equal(g.windows_at[d], ref.windows_at[d])
    assert_same_histogram(g._histogram_native, ref._histogram_native)
    # explicit, unsorted windows_at
    at = {"line": np.array([900.0, 40.0, 1500.0]), "sample": np.array([700.0, 100.0])}
    got = Gradients2D(da, window_size=150.0, windows_at=at, device="cpu").histogram
    assert_same_histogram(got, JG.Gradients2D(jda, window_size=150.0, windows_at=at).histogram)


def test_gradients_multiscale_dims_and_values():
    img = streak_image(300, 280)
    kw = dict(dims=("pol", "line", "sample"),
              coords={"pol": np.array(["VV", "VH"]), "line": np.arange(300),
                      "sample": np.arange(280)})
    jda, da = _pair(np.stack([img, img * 1.1]), **kw)
    hist = Gradients(da, windows_sizes=[80, 160], downscales_factors=[1, 2],
                     device="cpu").histogram
    w = hist["weight"]
    assert w.dims == ("pol", "downscale_factor", "window_size", "line", "sample", "angles")
    assert (w.sizes["pol"], w.sizes["downscale_factor"], w.sizes["window_size"]) == (2, 2, 2)
    np.testing.assert_array_equal(w.coords["downscale_factor"], [1, 2])
    assert_same_histogram(hist, JG.Gradients(jda, windows_sizes=[80, 160],
                                             downscales_factors=[1, 2]).histogram)
    # a 2-D image gets a virtual pol that is dropped again
    h2 = Gradients(img, windows_sizes=[80], downscales_factors=[1, 3], device="cpu").histogram
    assert h2["weight"].dims == ("downscale_factor", "window_size", "line", "sample", "angles")
    assert_same_histogram(h2, JG.Gradients(img, windows_sizes=[80],
                                           downscales_factors=[1, 3]).histogram)


def test_fused_histogram_matches_instance_path():
    img = streak_image(320, 288, angle_deg=40.0)
    kw = dict(dims=("pol", "line", "sample"),
              coords={"pol": np.array(["VV", "VH"]), "line": np.arange(320.0) * 5,
                      "sample": np.arange(288.0) * 5})
    jda, da = _pair(np.stack([img, 0.3 * img]), **kw)
    sizes = dict(windows_sizes=[400, 640], downscales_factors=[1, 2])

    fused = Gradients(da, device="cpu", **sizes).histogram
    g2 = Gradients(da, device="cpu", **sizes)
    assert len(g2.gradients_list) == 8  # touching the instances takes the per-instance path
    inst = g2.histogram
    assert fused["weight"].dims == inst["weight"].dims
    for k in ("line", "sample", "angles", "downscale_factor", "window_size", "pol"):
        np.testing.assert_array_equal(fused["weight"].coords[k], inst["weight"].coords[k])
    np.testing.assert_allclose(fused["weight"].values, inst["weight"].values, **HIST_TOL)
    np.testing.assert_array_equal(fused["used_ratio"].values, inst["used_ratio"].values)
    jg = JG.Gradients(jda, **sizes)
    jg.gradients_list
    assert_same_histogram(inst, jg.histogram)
    assert_same_histogram(fused, JG.Gradients(jda, **sizes).histogram)
    # the resampled instance carries the averaged coords and its factor
    s0 = Gradients._sigma0_resample(g2._pol_slices[0], 2, "cpu")
    ref = JG.Gradients._sigma0_resample(jg._pol_slices[0], 2)
    np.testing.assert_allclose(s0.values, np.asarray(ref.data), rtol=1e-12)
    for k in ("line", "sample", "downscale_factor"):
        np.testing.assert_array_equal(s0.coords[k], ref.coords[k])


def test_window_step_none_paths_agree():
    jda, da = _pair(**_one_pol())
    kw = dict(windows_sizes=[64], downscales_factors=[1])
    fused_none = Gradients(da, window_step=None, device="cpu", **kw).histogram
    fused_one = Gradients(da, window_step=1, device="cpu", **kw).histogram
    np.testing.assert_array_equal(fused_none["weight"].values, fused_one["weight"].values)
    g = Gradients(da, window_step=None, device="cpu", **kw)
    g.gradients_list
    np.testing.assert_allclose(g.histogram["weight"].values, fused_one["weight"].values,
                               **HIST_TOL)
    assert_same_histogram(fused_none, JG.Gradients(jda, window_step=None, **kw).histogram)


def test_n_angles_threads_through_both_paths():
    jda, da = _pair(**_one_pol())
    kw = dict(windows_sizes=[64], downscales_factors=[1])
    g_f = Gradients(da, device="cpu", **kw)
    g_f.n_angles = 36
    fused = g_f.histogram
    assert fused["weight"].sizes["angles"] == 36
    g_i = Gradients(da, device="cpu", **kw)
    g_i.n_angles = 36
    g_i.gradients_list
    np.testing.assert_allclose(fused["weight"].values, g_i.histogram["weight"].values, **HIST_TOL)
    jg = JG.Gradients(jda, **kw)
    jg.n_angles = 36
    assert_same_histogram(fused, jg.histogram)


def test_gradients_without_spatial_coords():
    img = streak_image(128, 128)
    kw = dict(dims=("pol", "line", "sample"), coords={"pol": np.array(["VV", "VH"])})
    jda, da = _pair(np.stack([img, img * 0.5]), **kw)
    h = Gradients(da, windows_sizes=[40], downscales_factors=[1], device="cpu").histogram
    assert h["weight"].dims[-1] == "angles" and np.isfinite(h["weight"].values).all()
    assert_same_histogram(h, JG.Gradients(jda, windows_sizes=[40],
                                          downscales_factors=[1]).histogram)


def test_hist_cache_invalidation_on_lg_reassign():
    img = streak_image(160, 160)
    g = Gradients2D(img, window_size=40, window_step=1, device="cpu")
    w_first = g.histogram["weight"].values.copy()
    lg = TG.local_gradients(Gradients2D(img, window_size=40, device="cpu").ampl)
    coords = {d: lg["G2_abs"].coords[d] for d in ("line", "sample")}

    def mk(a, n):
        return DimArray(a, dims=("line", "sample"), coords=coords, name=n)

    # numpy payloads injected: they go to the instance's device
    g._lg_hist = (mk(lg["G2_abs"].values * 0.0, "G2_abs"), mk(lg["G2_angle"].values, "G2_angle"),
                  mk(lg["c"].values, "c"))
    w_second = g.histogram["weight"].values
    assert not np.allclose(w_first, w_second)
    assert np.allclose(w_second, 0.0)  # all-zero |G2|: every pixel masked out
    # computing .local_gradients after a cached read invalidates too, and the
    # cached-lg branch agrees with the core
    g3 = Gradients2D(img, window_size=40, window_step=1, device="cpu")
    h_core = g3.histogram["weight"].values.copy()
    assert set(g3.local_gradients.variables) >= {"G2_abs", "G2_angle", "c", "G2"}
    np.testing.assert_allclose(g3.histogram["weight"].values, h_core, **HIST_TOL)
    assert g3._lg_gen == 1


def test_fused_cache_invalidates_on_windows_sizes_mutation():
    _, da = _pair(**_one_pol())
    g = Gradients(da, windows_sizes=[64], downscales_factors=[1], device="cpu")
    h1 = g.histogram
    assert h1["weight"].sizes["window_size"] == 1 and g.histogram["weight"] is h1["weight"]
    g.windows_sizes.append(96)
    h2 = g.histogram
    assert h2["weight"].sizes["window_size"] == 2
    np.testing.assert_array_equal(h2["weight"].coords["window_size"], [64, 96])


def test_gradients_instance_mutation_honored():
    jda, da = _pair(**_one_pol(256, 256))
    at = {"line": np.array([64.0, 192.0]), "sample": np.array([128.0])}
    g = Gradients(da, windows_sizes=[64], downscales_factors=[1], device="cpu")
    jg = JG.Gradients(jda, windows_sizes=[64], downscales_factors=[1])
    for inst in g.gradients_list + jg.gradients_list:
        inst.windows_at = at
    h = g.histogram
    assert h["weight"].sizes["line"] == 2 and h["weight"].sizes["sample"] == 1
    np.testing.assert_array_equal(h["weight"].coords["line"], at["line"])
    assert_same_histogram(h, jg.histogram)


def test_tensor_payload_and_float32():
    """A tensor sigma0 is analysed where it lives, with no device named; in
    float32 the histogram stays within 1e-3 of the float64 one."""
    spec = _one_pol()
    ref = Gradients(DimArray(**spec), windows_sizes=[64], downscales_factors=[1, 2],
                    device="cpu").histogram
    spec_t = dict(spec, data=torch.as_tensor(spec["data"]))
    got = Gradients(DimArray(**spec_t), windows_sizes=[64], downscales_factors=[1, 2]).histogram
    np.testing.assert_array_equal(got["weight"].values, ref["weight"].values)
    spec32 = dict(spec, data=torch.as_tensor(spec["data"], dtype=torch.float32))
    got32 = Gradients(DimArray(**spec32), windows_sizes=[64], downscales_factors=[1, 2]).histogram
    assert got32["weight"].values.dtype == np.float32
    assert np.abs(got32["weight"].values - ref["weight"].values).max() <= 1e-3
    if not torch.cuda.is_available():
        for make in (lambda: Gradients(DimArray(**spec)), lambda: Gradients2D(spec["data"][0]),
                     lambda: TG.local_gradients(spec["data"][0]),
                     lambda: TG.streaks_histogram_core(spec["data"][0], [5], [5], 4,
                                                       TG._angle_bin_centers(72)),
                     lambda: TG.circ_smooth(np.ones(72)),
                     lambda: TG.filtering_parameters(spec["data"][0])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# ------------------------------------------------------------- chunked inputs

def test_chunked_gradients2d_matches_eager():
    ny, nx = 504, 240
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:ny, 0:nx]
    img = (1.0 + 0.4 * np.sin(0.3 * (xx + 0.7 * yy)) + 0.1 * rng.normal(size=(ny, nx))) ** 2
    kw = dict(dims=("line", "sample"),
              coords={"line": np.arange(ny, dtype=float), "sample": np.arange(nx, dtype=float)})
    eager = Gradients2D(DimArray(img, **kw), window_size=64, window_step=1,
                        device="cpu")._histogram_native
    lazy = LazyRows(lambda a, b: img[a:b], img.shape)
    banded = Gradients2D(DimArray(lazy, **kw), window_size=64, window_step=1,
                         device="cpu")._histogram_native
    # the whole image fits one band here: the same core on the same rows
    np.testing.assert_array_equal(banded["weight"].values, eager["weight"].values)
    np.testing.assert_array_equal(banded["used_ratio"].values, eager["used_ratio"].values)
    assert lazy.max_request == img.size
    assert_same_histogram(banded, JG.Gradients2D(
        JDimArray(LazyRows(lambda a, b: img[a:b], img.shape), **kw), window_size=64,
        window_step=1)._histogram_native)


def test_multiscale_gradients_chunked_input():
    ny, nx = 256, 160
    img = np.abs(np.random.default_rng(6).normal(1.0, 0.3, (ny, nx))) + 0.05
    kw = dict(dims=("line", "sample"),
              coords={"line": np.arange(ny, dtype=float), "sample": np.arange(nx, dtype=float)})
    lazy = LazyRows(lambda a, b: img[a:b], img.shape)
    h = Gradients(DimArray(lazy, **kw), windows_sizes=[40, 64], downscales_factors=[1],
                  device="cpu").histogram
    eager = Gradients(DimArray(img, **kw), windows_sizes=[40, 64], downscales_factors=[1],
                      device="cpu").histogram
    assert h["weight"].dims == eager["weight"].dims
    np.testing.assert_allclose(h["weight"].values, eager["weight"].values, **HIST_TOL)
    assert 0 < lazy.max_request <= img.size
    assert_same_histogram(h, JG.Gradients(
        JDimArray(LazyRows(lambda a, b: img[a:b], img.shape), **kw), windows_sizes=[40, 64],
        downscales_factors=[1]).histogram)
    with pytest.raises(NotImplementedError, match="downscales_factors"):
        Gradients(DimArray(LazyRows(lambda a, b: img[a:b], img.shape), **kw),
                  windows_sizes=[40], downscales_factors=[1, 2], device="cpu")


def test_multipol_chunked_gradients_matches_eager():
    ny, nx = 256, 224
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:ny, 0:nx]
    base = (1.0 + 0.4 * np.sin(0.3 * (xx + 0.7 * yy)) + 0.1 * rng.normal(size=(ny, nx))) ** 2
    img3 = np.stack([base, 0.25 * base])
    kw = dict(dims=("pol", "line", "sample"),
              coords={"pol": np.array(["VV", "VH"]), "line": np.arange(ny, dtype=float),
                      "sample": np.arange(nx, dtype=float)})
    eager = Gradients(DimArray(img3, **kw), windows_sizes=[64], downscales_factors=[1],
                      device="cpu").histogram
    lazy = Lazy3D(img3)
    got = Gradients(DimArray(lazy, **kw), windows_sizes=[64], downscales_factors=[1],
                    device="cpu").histogram
    assert got["weight"].dims == eager["weight"].dims
    np.testing.assert_allclose(got["weight"].values, eager["weight"].values, **HIST_TOL)
    np.testing.assert_array_equal(got["used_ratio"].values, eager["used_ratio"].values)
    assert 0 < lazy.max_request <= ny * nx  # never more than one pol's row band
    assert_same_histogram(got, JG.Gradients(JDimArray(img3, **kw), windows_sizes=[64],
                                            downscales_factors=[1]).histogram)


def test_chunked_refusals():
    """The three refusals: a downscale factor on a chunked 3-D source, on a
    chunked slice at resampling time, and a 3-D source that slices its first
    axis only."""
    with pytest.raises(NotImplementedError, match="downscales_factors"):
        Gradients(DimArray(Lazy3D(np.ones((2, 64, 64))), dims=("pol", "line", "sample")),
                  windows_sizes=[32], downscales_factors=[1, 2], device="cpu")
    lazy2d = DimArray(LazyRows(lambda a, b: np.ones((b - a, 64)), (64, 64)),
                      dims=("line", "sample"))
    with pytest.raises(NotImplementedError, match="downscales_factors"):
        Gradients._sigma0_resample(lazy2d, 2, "cpu")
    img3 = np.ones((2, 64, 64))

    class FirstAxisOnly:
        shape, ndim, dtype = img3.shape, 3, img3.dtype
        chunks = ((2,), (64,), (64,))

        def __getitem__(self, idx):
            if not isinstance(idx, tuple):
                idx = (idx,)
            if len(idx) != 1 or not isinstance(idx[0], slice):
                raise IndexError("first-axis slicing only")
            return img3[idx]

    with pytest.raises(NotImplementedError, match="pol, row0:row1"):
        Gradients(DimArray(FirstAxisOnly(), dims=("pol", "line", "sample")),
                  windows_sizes=[32], downscales_factors=[1], device="cpu")


# ------------------------------------------------------------ post-processing

def test_circ_smooth_matches_jax():
    h = np.random.default_rng(0).uniform(0, 1, size=(3, 72))
    kw = dict(dims=("w", "angles"), coords={"angles": np.linspace(-np.pi / 2, np.pi / 2, 72)})
    jda, da = _pair(h, **kw)
    got = TG.circ_smooth(da, device="cpu")
    assert got.dims == ("w", "angles")
    np.testing.assert_allclose(got.values, np.asarray(JG.circ_smooth(jda).data), rtol=1e-12,
                               atol=1e-14)
    # the angles need not be the last axis; a bare array is one histogram
    np.testing.assert_array_equal(
        TG.circ_smooth(DimArray(h.T, dims=("angles", "w")), device="cpu").values, got.values.T)
    np.testing.assert_array_equal(TG.circ_smooth(h[0], device="cpu").values, got.values[0])
    # smoothing keeps the histogram's sum (the kernels sum to 1, circularly)
    np.testing.assert_allclose(got.values.sum(axis=1), h.sum(axis=1), rtol=1e-12)


def test_circ_hist_contract():
    w = np.random.default_rng(0).uniform(0, 1, 72)
    kw = dict(dims=("angles",), coords={"angles": np.linspace(-np.pi / 2, np.pi / 2, 72)})
    jda, da = _pair(w, **kw)
    df = TG.circ_hist(da)
    assert list(df.columns) == ["line_g", "sample_g"] and len(df) == 145  # 2*72 + closing point
    np.testing.assert_allclose(df.iloc[0], df.iloc[-1])
    np.testing.assert_array_equal(df.to_numpy(), JG.circ_hist(jda).to_numpy())
    np.testing.assert_array_equal(
        TG.circ_hist(DimArray(torch.as_tensor(w), **kw)).to_numpy(), df.to_numpy())


def test_filtering_parameters_matches_jax():
    img = streak_image(128, 128)
    got = TG.filtering_parameters(img, device="cpu")
    ref = JG.filtering_parameters(img)
    for g, r, name in zip(got, ref, "f1 f2 f3 f4 F".split()):
        assert g.shape == (64, 64) and g.dims == r.dims
        np.testing.assert_allclose(g.values, np.asarray(r.data), rtol=1e-9, atol=1e-12,
                                   err_msg=name)
        for d in ("line", "sample"):
            np.testing.assert_array_equal(g.coords[d], r.coords[d])
    assert 0.0 <= got[4].values.min() and got[4].values.max() <= 1.0


# ----------------------------------------------------------- DataArray bridge

def test_dataarray_in_dataset_out():
    img = streak_image(160, 144)
    coords = {"line": np.arange(160.0), "sample": np.arange(144.0)}
    da = _xr_stub.DataArray(img, coords=coords, dims=("line", "sample"), attrs={"units": "lin"})
    ds = Gradients2D(da, window_size=40, device="cpu").histogram
    assert isinstance(ds, _xr_stub.Dataset) and set(ds.variables) == {"weight", "used_ratio"}
    w = ds["weight"]
    assert isinstance(w, _xr_stub.DataArray) and isinstance(w.values, np.ndarray)
    assert w.dims == ("line", "sample", "angles")
    native = Gradients2D(DimArray(img, dims=("line", "sample"), coords=coords), window_size=40,
                         device="cpu").histogram
    np.testing.assert_array_equal(w.values, native["weight"].values)
    np.testing.assert_array_equal(w.coords["line"], native["weight"].coords["line"])
    # the multiscale class: a stub in, a stub Dataset out, the virtual pol dropped
    ms = Gradients(da, windows_sizes=[40, 64], downscales_factors=[1, 2], device="cpu").histogram
    assert isinstance(ms, _xr_stub.Dataset)
    assert ms["weight"].dims == ("downscale_factor", "window_size", "line", "sample", "angles")
    ref = JG.Gradients(JDimArray(img, dims=("line", "sample"), coords=coords),
                       windows_sizes=[40, 64], downscales_factors=[1, 2]).histogram
    np.testing.assert_allclose(ms["weight"].values, np.asarray(ref["weight"].data), **HIST_TOL)
    # a chunked DataArray stays lazy on the way in
    lazy = LazyRows(lambda a, b: img[a:b], img.shape)
    ds_lazy = Gradients2D(_xr_stub.DataArray(lazy, coords=coords, dims=("line", "sample")),
                          window_size=40, device="cpu").histogram
    np.testing.assert_array_equal(ds_lazy["weight"].values, w.values)
    assert 0 < lazy.max_request <= img.size
