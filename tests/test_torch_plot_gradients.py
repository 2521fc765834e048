"""The port's ``PlotGradients`` against the JAX package's, on the CPU.

Ports ``tests/test_gradients.py:282-325`` and ``:435-474``. The peak dataset
is computed from one numpy histogram by both packages and must be equal:
angle and weight exact (an argmax and a gather pick values, they compute
none), NaN weighing nothing and ties going to the first maximum, as
``jnp.argmax``. The matplotlib methods draw with Agg and save; the holoviews
helpers (combos, styles, nearest centre) are held to the JAX package's; and
without holoviews the interactive methods raise the JAX package's
``ImportError``.
"""

import sys

import numpy as np
import pytest
import torch

from xsarsea_tpu import gradients as JG
from xsarsea_tpu.dimarray import DimArray as JDimArray, DimDataset as JDimDataset
from xsarsea_tpu_torch import gradients as TG
from xsarsea_tpu_torch.dimarray import DimArray, DimDataset

from test_torch_gradients_core import streak_image

torch.set_num_threads(min(2, torch.get_num_threads()))


def _hist_pair(weight, dims, coords):
    """The same numpy histogram as a JAX and a port DimDataset."""
    ratio_dims = dims[:-1]
    ratio = np.linspace(0.5, 1.0, int(np.prod(weight.shape[:-1]))).reshape(weight.shape[:-1])
    rc = {k: v for k, v in coords.items() if k != "angles"}
    return (JDimDataset({"weight": JDimArray(weight, dims=dims, coords=coords),
                         "used_ratio": JDimArray(ratio, dims=ratio_dims, coords=rc)}),
            DimDataset({"weight": DimArray(torch.as_tensor(np.array(weight)), dims=dims,
                                           coords=coords),
                        "used_ratio": DimArray(ratio, dims=ratio_dims, coords=rc)}))


def _assert_same_peak(jpk, ppk):
    for key in ("angle", "weight"):
        j, p = jpk[key], ppk[key]
        assert tuple(p.dims) == tuple(j.dims)
        assert isinstance(p.data, torch.Tensor)
        np.testing.assert_array_equal(p.values, np.asarray(j.data), err_msg=key)
        for d in p.dims:
            np.testing.assert_array_equal(np.asarray(p.coords[d]), np.asarray(j.coords[d]))
    np.testing.assert_array_equal(np.asarray(ppk["used_ratio"].values),
                                  np.asarray(jpk["used_ratio"].data))


def test_peak_equals_jax_on_a_gradients_histogram():
    img = streak_image(256, 256)
    da = JDimArray(np.stack([img, img * 1.05]), dims=("pol", "line", "sample"),
                   coords={"pol": np.array(["VV", "VH"]), "line": np.arange(256.0),
                           "sample": np.arange(256.0)})
    hist = JG.Gradients(da, windows_sizes=[64, 96], downscales_factors=[1]).histogram
    w = hist["weight"]
    jh, ph = _hist_pair(np.asarray(w.data), tuple(w.dims), dict(w.coords))
    _assert_same_peak(JG.PlotGradients(jh).peak, TG.PlotGradients(ph).peak)


def test_peak_ties_nan_and_inf_as_jax():
    rng = np.random.default_rng(5)
    # coarse weights: many exact ties between bins; NaN, +-inf and all-NaN windows
    weight = rng.integers(0, 4, (3, 5, 4, 72)).astype(np.float64) / 4.0
    weight[0, 0, 0, :10] = np.nan
    weight[0, 1, 0, :] = np.nan
    weight[1, 2, 3, 5] = np.inf
    weight[2, 4, 1, 7] = -np.inf
    weight[2, 3, 2, :] = 0.0
    coords = {"window_size": np.array([10.0, 20.0, 30.0]), "line": np.arange(5.0) * 4,
              "sample": np.arange(4.0) * 4,
              "angles": np.linspace(-np.pi / 2, np.pi / 2, 72, endpoint=False)}
    dims = ("window_size", "line", "sample", "angles")
    jh, ph = _hist_pair(weight, dims, coords)
    jpk, ppk = JG.PlotGradients(jh).peak, TG.PlotGradients(ph).peak
    _assert_same_peak(jpk, ppk)
    assert np.isnan(ppk["weight"].values[0, 1, 0])  # an all-NaN window keeps its NaN weight
    assert ppk["angle"].values[2, 3, 2] == coords["angles"][0]  # all ties: the first bin


def test_peak_stays_on_the_histogram_device_and_dtype():
    img = streak_image(128, 128)
    hist = TG.Gradients2D(img, window_size=48, device="cpu").histogram
    pk = TG.PlotGradients(hist).peak
    w = hist["weight"].data
    assert pk["angle"].data.device == w.device and pk["weight"].data.dtype == w.dtype
    assert pk["angle"].dims == ("line", "sample")


def test_plot_gradients_matplotlib(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = streak_image(300, 300)
    pg = TG.PlotGradients(TG.Gradients2D(img, window_size=100, device="cpu").histogram)
    assert "angle" in pg.peak.variables
    ax = pg.vectorfield()
    assert len(ax.collections) >= 1
    ax.figure.savefig(tmp_path / "quiver.png")
    plt.close(ax.figure)
    ax2 = pg.histogram_plot(line=150, sample=150)
    assert len(ax2.lines) == 1 and len(ax2.lines[0].get_xdata()) == 145  # 2 x 72 + closing
    ax2.figure.savefig(tmp_path / "hist.png")
    plt.close(ax2.figure)
    assert (tmp_path / "quiver.png").stat().st_size > 0 and (tmp_path / "hist.png").exists()


def test_plot_gradients_matplotlib_multiscale(tmp_path):
    """A (pol, downscale_factor, window_size) histogram reduced to 2-D, as
    the JAX smoke test draws it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = streak_image(256, 256)
    da = DimArray(img[None], dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV"]), "line": np.arange(256),
                          "sample": np.arange(256)})
    hist = TG.Gradients(da, windows_sizes=[80], downscales_factors=[1], device="cpu").histogram
    w = hist["weight"].mean(dim=["pol", "downscale_factor", "window_size"])
    ratio = hist["used_ratio"]
    pg = TG.PlotGradients(DimDataset({
        "weight": w,
        "used_ratio": ratio.mean(dim=[d for d in ratio.dims if d not in ("line", "sample")])}))
    ax = pg.vectorfield()
    ax.figure.savefig(tmp_path / "quiver.png")
    plt.close(ax.figure)
    ax2 = pg.histogram_plot(line=0, sample=0)
    ax2.figure.savefig(tmp_path / "hist.png")
    plt.close(ax2.figure)


def test_plot_gradients_hv_helpers_match_jax():
    img = streak_image(256, 256)
    stack = np.stack([img, img * 1.05])
    coords = {"pol": np.array(["VV", "VH"]), "line": np.arange(256.0),
              "sample": np.arange(256.0)}
    dims = ("pol", "line", "sample")
    kw = dict(windows_sizes=[64, 96], downscales_factors=[1])
    pg = TG.PlotGradients(TG.Gradients(DimArray(stack, dims=dims, coords=coords),
                                       device="cpu", **kw).histogram)
    jpg = JG.PlotGradients(JG.Gradients(JDimArray(stack, dims=dims, coords=coords),
                                        **kw).histogram)
    combos = pg._combos()
    # pol(2) x downscale_factor(1) x window_size(2) = 4 combos
    assert len(combos) == 4 and combos == jpg._combos()
    assert pg.dim_styles == jpg.dim_styles
    st = pg._style_for({"pol": 1, "window_size": 0, "downscale_factor": 0})
    assert st["line_dash"] == "dotted" and st["line_color"] == "blue"
    for sel in combos:
        assert pg._style_for(sel) == jpg._style_for(sel)
    line, sample, ang, wgt = pg._peak_2d(combos[0])
    assert ang.shape == (len(line), len(sample)) == wgt.shape
    jline, jsample, _, _ = jpg._peak_2d(combos[0])
    np.testing.assert_array_equal(line, jline)
    np.testing.assert_array_equal(sample, jsample)
    # nearest-center snapping
    s, ln = pg._nearest_center(sample[0] + 0.1, line[-1] + 5.0)
    assert s == sample[0] and ln == line[-1]
    assert (s, ln) == jpg._nearest_center(sample[0] + 0.1, line[-1] + 5.0)


def test_plot_gradients_without_holoviews_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "holoviews", None)
    pg = TG.PlotGradients(TG.Gradients2D(streak_image(128, 128), window_size=48,
                                         device="cpu").histogram)
    with pytest.raises(ImportError) as port_err:
        pg.hv_vectorfield()
    with pytest.raises(ImportError) as jax_err:
        JG.PlotGradients._hv()
    assert str(port_err.value) == str(jax_err.value)
    assert "vectorfield()/histogram_plot()" in str(port_err.value)
    for method in (pg.hv_histogram_plot, pg.mouse_histogram):
        with pytest.raises(ImportError, match="holoviews"):
            method()
