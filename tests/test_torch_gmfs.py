"""The port's GMFs, LUTs, registry and DimArray against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU in float64 (tests/conftest.py), the port evaluates numpy inputs
in float64. Tolerance: rtol=1e-10, the JAX package's own GMF tolerance
(tests/test_gmfs.py); the two libraries' exp/pow/tanh/log10 may differ in
the last ulps, nothing more.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu.dimarray import DimArray as JDimArray
from xsarsea_tpu.models import get_model as jax_model
from xsarsea_tpu.utils import from_dB as jax_from_dB
from xsarsea_tpu.utils import to_dB as jax_to_dB
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.models import GmfModel, available_models, get_model
from xsarsea_tpu_torch.utils import from_dB, to_dB

# tier-1 runs six pytest workers on one host: two torch threads each keep
# them from oversubscribing its cores
torch.set_num_threads(min(2, torch.get_num_threads()))

COPOL = ["gmf_cmod5", "gmf_cmod5n", "gmf_cmod5n_pr_zhangA", "gmf_cmod5n_pr_mouche1",
         "gmf_cmodifr2"]
XPOL = ["gmf_rs2_v2", "gmf_s1_v2", "gmf_rcm_noaa", "gmf_s1_v3_ew_rec", "gmf_rs2_v3",
        "gmf_rcm_v3", "gmf_rcm_v4", "gmf_rs2_v4"]
RTOL = 1e-10


def _scene(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(16.0, 66.0, n), rng.uniform(0.2, 80.0, n),
            rng.uniform(-360.0, 360.0, n))


@pytest.mark.parametrize("name", COPOL + XPOL)
def test_gmf_broadcast_matches_jax(name):
    inc, wspd, phi = _scene()
    got = get_model(name)(inc, wspd, phi, broadcast=True)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    ref = np.asarray(jax_model(name)(inc, wspd, phi, broadcast=True))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)
    assert get_model(name).phi_range == jax_model(name).phi_range
    assert get_model(name).wspd_range == jax_model(name).wspd_range


@pytest.mark.parametrize("name", ["gmf_cmod5n", "gmf_cmodifr2", "gmf_s1_v2"])
def test_gmf_scalar_and_grid_calls(name):
    port, ref = get_model(name), jax_model(name)
    phi = 45.0 if port.phi_range else None
    got = port(35.0, 12.0, phi)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, ref(35.0, 12.0, phi), rtol=RTOL)

    inc, wspd = np.linspace(17, 60, 7), np.linspace(3, 40, 9)
    phis = np.linspace(0, 180, 5) if phi is not None else None
    grid = port(inc, wspd, phis)
    assert isinstance(grid, DimArray)
    assert grid.dims == (("incidence", "wspd", "phi") if phi else ("incidence", "wspd"))
    np.testing.assert_allclose(grid.values, np.asarray(ref(inc, wspd, phis).data), rtol=RTOL)
    np.testing.assert_array_equal(grid.coords["wspd"], wspd)


def test_gmf_tensor_inputs_keep_dtype():
    inc = torch.linspace(20, 45, 11, dtype=torch.float32)
    out = get_model("gmf_cmod5n")(inc, torch.full_like(inc, 10.0), torch.full_like(inc, 30.0),
                                  broadcast=True)
    assert out.dtype == torch.float32 and out.shape == (11,)
    ref = get_model("gmf_cmod5n")(inc.double(), 10.0, 30.0, broadcast=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["gmf_cmod5n", "gmf_cmod5n_pr_mouche1", "gmf_s1_v2",
                                  "gmf_rcm_v4"])
@pytest.mark.parametrize("kwargs", [dict(resolution="low"),
                                    dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)])
def test_to_lut_matches_jax(name, kwargs):
    for units in ("linear", "dB"):
        got = get_model(name).to_lut(units=units, **kwargs)
        ref = jax_model(name).to_lut(units=units, **kwargs)
        assert got.dims == ref.dims and got.shape == ref.shape
        for dim in got.dims:
            np.testing.assert_array_equal(got.coords[dim], np.asarray(ref.coords[dim]))
        # dB values cross 0: an absolute floor of 1e-12 dB keeps the
        # relative test meaningful there
        np.testing.assert_allclose(got.data, np.asarray(ref.data), rtol=RTOL,
                                   atol=1e-12 if units == "dB" else 0)
        assert got.attrs["units"] == units and got.attrs["model"] == name


def test_high_res_lut_is_lerp_of_low_res():
    """High-res values ARE the lerp of the low-res analytic grid: the
    interp formula, applied to identical low-res bits, gives identical
    bits in both packages."""
    low = jax_model("gmf_cmod5n").to_lut(units="linear", resolution="low")
    target = {"incidence": np.linspace(16, 66, 101), "wspd": np.linspace(0.2, 50, 100),
              "phi": np.linspace(0, 180, 37)}
    ref = JDimArray(np.asarray(low.data), dims=low.dims,
                    coords={k: np.asarray(v) for k, v in low.coords.items()}
                    ).interp(target, bounds_error=True)
    got = DimArray(np.asarray(low.data), dims=low.dims,
                   coords={k: np.asarray(v) for k, v in low.coords.items()}
                   ).interp(target, bounds_error=True)
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))
    tensor = DimArray(torch.as_tensor(np.array(low.data)), dims=low.dims,
                      coords=low.coords).interp(target, bounds_error=True)
    np.testing.assert_array_equal(tensor.values, np.asarray(ref.data))


def test_dimarray_interp_edges():
    rng = np.random.default_rng(4)
    data = rng.normal(size=(5, 4))
    coords = {"x": np.array([4.0, 3.0, 2.0, 1.0, 0.0]), "y": np.arange(4.0)}
    new = np.array([-0.5, 0.0, 1.25, 3.999, 4.0, 4.5])
    got = DimArray(data, dims=("x", "y"), coords=coords).interp({"x": new})
    ref = JDimArray(data, dims=("x", "y"), coords=coords).interp({"x": new})
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))
    with pytest.raises(ValueError):
        DimArray(data, dims=("x", "y"), coords=coords).interp({"x": new}, bounds_error=True)
    # scalar target drops the dim, as isel with an int
    one = DimArray(data, dims=("x", "y"), coords=coords).interp({"y": 1.5})
    assert one.dims == ("x",)
    np.testing.assert_array_equal(one.data, (data[:, 1] * 0.5 + data[:, 2] * 0.5))


def test_dimarray_isel_copy_attrs():
    t = torch.arange(24.0).reshape(2, 3, 4)
    a = DimArray(t, dims=("a", "b", "c"), coords={"c": np.arange(4) * 2.0},
                 attrs={"units": "dB"}, name="x")
    sub = a.isel(a=1, c=slice(None, None, -1))
    assert sub.dims == ("b", "c") and sub.shape == (3, 4)
    np.testing.assert_array_equal(sub.values, t[1].flip(-1).numpy())
    np.testing.assert_array_equal(sub.coords["c"], [6.0, 4.0, 2.0, 0.0])
    b = a.assign_attrs(model="m")
    assert b.attrs == {"units": "dB", "model": "m"} and a.attrs == {"units": "dB"}
    assert a.copy(data=t * 2).name == "x"


def test_db_conversions_match_jax():
    x = np.random.default_rng(1).uniform(0, 0.5, 100)
    np.testing.assert_array_equal(to_dB(x), np.asarray(jax_to_dB(x)))
    np.testing.assert_allclose(to_dB(torch.as_tensor(x)).numpy(), to_dB(x), rtol=1e-15)
    np.testing.assert_allclose(from_dB(to_dB(x)), x + 1e-15, rtol=1e-12)
    np.testing.assert_array_equal(from_dB(np.array([-10.0, 3.0])),
                                  np.asarray(jax_from_dB(np.array([-10.0, 3.0]))))


def test_registry_aliases_and_errors():
    table = available_models()
    assert table["gmf_cmod5n"]["alias"] == "cmod5n"
    assert table["gmf_s1_v2"]["pol"] == "VH"
    assert get_model("cmod5n") is get_model("gmf_cmod5n")
    assert get_model(get_model("s1_v2")) is get_model("gmf_s1_v2")
    assert set(XPOL) <= set(available_models(pol="VH")) and not set(COPOL) & set(
        available_models(pol="VH"))
    with pytest.raises(KeyError, match="nope"):
        get_model("nope")
    with pytest.raises(ValueError, match="phi"):
        get_model("gmf_cmod5n")(35.0, 10.0)


def test_alias_table_matches_jax():
    from xsarsea_tpu.models import available_models as jax_available

    ref = jax_available()
    port = available_models()
    for name in COPOL + XPOL:
        assert port[name]["alias"] == ref.loc[name, "alias"]
        assert port[name]["pol"] == ref.loc[name, "pol"]


def test_register_user_gmf_and_phi_probe():
    @GmfModel.register(pol="VV", units="linear", defer=False)
    def gmf_torch_test_asym(inc, wspd, phi):
        return 1e-3 * wspd * (1.5 + torch.as_tensor(np.sin(np.deg2rad(phi))))

    @GmfModel.register(pol="VH", units="linear", defer=False)
    def gmf_torch_test_xpol(inc, wspd, phi=None):
        return 1e-4 * (1.0 + 0.01 * torch.as_tensor(inc)) * torch.as_tensor(wspd) ** 1.39

    assert get_model("gmf_torch_test_asym").phi_range == [0.0, 360.0]
    assert get_model("torch_test_xpol").phi_range is None
    assert get_model("gmf_torch_test_xpol").wspd_range == [3.0, 80.0]
    with pytest.raises(ValueError, match="gmf_"):
        GmfModel.register(pol="VV")(lambda inc, wspd, phi: inc)

    lut = get_model("gmf_torch_test_xpol").to_lut(units="dB", inc_step=5.0, wspd_step=7.0)
    assert lut.dims == ("incidence", "wspd") and not lut.data.flags.writeable
    again = get_model("gmf_torch_test_xpol").to_lut(units="dB", inc_step=5.0, wspd_step=7.0)
    assert again.data is lut.data and again is not lut
