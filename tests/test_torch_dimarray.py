"""The port's DimArray and DimDataset against the JAX package's, on the CPU.

A counterpart for each case of tests/test_dimarray.py (the pytree round
trip apart: the port has ``to(device)`` and ``numpy()`` in its place), each
on a numpy payload and on a CPU tensor payload. The same operation runs on
the JAX class over the same numpy data. Tolerances: on a numpy payload the
port's result is bit-equal to the JAX class's; on a tensor payload
selections, arithmetic, comparisons, ``where``/``fillna``, ``pad`` and the
lerp are bit-equal too, and reductions (``mean``, ``nanmean``, ``sum``,
``coarsen_mean``) agree to rtol 1e-12 in float64, since torch sums in
another order than numpy.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

from xsarsea_tpu.dimarray import DimArray as JDimArray, DimDataset as JDimDataset
from xsarsea_tpu_torch.dimarray import DimArray, DimDataset, blocked_coord_mean, is_chunked

KINDS = ["numpy", "tensor"]
pytestmark = pytest.mark.parametrize("kind", KINDS)


def port(data, kind, **kw):
    data = np.asarray(data)
    return DimArray(torch.as_tensor(data) if kind == "tensor" else data, **kw)


def both(data, kind, **kw):
    """The port's array in ``kind`` and the JAX class's on the same numpy data."""
    return port(data, kind, **kw), JDimArray(np.asarray(data), **kw)


def same(got, ref, rtol=0.0):
    """Same dims, coords and attrs; payload of the expected kind, equal to
    the JAX class's (bit for bit unless ``rtol`` is given)."""
    assert isinstance(got, DimArray) and got.dims == ref.dims, (got, ref)
    assert set(got.coords) == set(ref.coords)
    for k, v in ref.coords.items():
        np.testing.assert_array_equal(got.coords[k], v)
    assert got.attrs == ref.attrs and got.name == ref.name
    g, r = got.values, np.asarray(ref.data)
    assert g.dtype == r.dtype, (g.dtype, r.dtype)
    if rtol:
        np.testing.assert_allclose(g, r, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(g, r)


def kind_of(arr):
    return "tensor" if isinstance(arr.data, torch.Tensor) else "numpy"


LUT_KW = dict(dims=("incidence", "wspd", "phi"),
              coords={"incidence": [20.0, 30.0], "wspd": [1.0, 2.0, 3.0],
                      "phi": [0.0, 90.0, 180.0, 270.0]}, attrs={"units": "linear"})
LUT = np.arange(24, dtype=np.float64).reshape(2, 3, 4)


def test_isel_and_sel(kind):
    da, ref = both(LUT, kind, **LUT_KW)
    for op in (lambda a: a.isel(wspd=1), lambda a: a.sel(incidence=30.0),
               lambda a: a.sel({"phi": 100.0}, method="nearest"),
               lambda a: a.sel(phi=[90.0, 270.0]), lambda a: a.isel(phi=slice(None, None, -1))):
        got = op(da)
        same(got, op(ref))
        assert kind_of(got) == kind
    assert da.isel(wspd=1).shape == (2, 4)
    np.testing.assert_array_equal(da.wspd, ref.wspd)  # coords as attributes
    assert len(da) == len(ref) == 2 and da.size == ref.size == 24
    with pytest.raises(AttributeError):
        da.no_such_coord


def test_interp_matches_scipy(kind):
    from scipy.interpolate import interpn

    rng = np.random.default_rng(0)
    data = rng.normal(size=(5, 7, 9))
    coords = {"incidence": np.linspace(16, 66, 5), "wspd": np.linspace(0.2, 50, 7),
              "phi": np.linspace(0, 180, 9)}
    da, ref = both(data, kind, dims=("incidence", "wspd", "phi"), coords=coords)
    new = dict(incidence=np.linspace(16, 66, 11), wspd=np.linspace(0.2, 50, 13),
               phi=np.linspace(0, 180, 17))
    got = da.interp(**new)
    same(got, ref.interp(**new))
    pts = np.stack(np.meshgrid(*new.values(), indexing="ij"), axis=-1)
    np.testing.assert_allclose(got.values, interpn(tuple(coords.values()), data, pts),
                               rtol=1e-12)


def test_sel_above_max_raises_keyerror(kind):
    da = port(np.arange(4.0), kind, dims=("x",), coords={"x": [0.0, 1.0, 2.0, 3.0]})
    with pytest.raises(KeyError):
        da.sel(x=100.0)
    with pytest.raises(KeyError):
        da.sel(x=1.5)  # between grid points: still KeyError
    assert da.sel(x=3.0).item() == 3.0  # exact max works


def test_interp_identity_is_exact(kind):
    kw = dict(dims=("x",), coords={"x": [0.0, 1.0, 2.0, 3.0]})
    da, ref = both(np.array([1.0, np.nan, 3.0, 4.0]), kind, **kw)
    x = np.array([0.0, 1.0, 2.0, 3.0])
    same(da.interp(x=x), ref.interp(x=x))
    np.testing.assert_array_equal(da.interp(x=x).values, [1.0, np.nan, 3.0, 4.0])
    kw2 = dict(dims=("a", "b"), coords={"a": [0.0, 1.0, 2.0], "b": [0.0, 1.0, 2.0, 3.0]})
    d2, r2 = both(np.arange(12.0).reshape(3, 4), kind, **kw2)
    new = dict(a=np.array([0.0, 1.0, 2.0]), b=np.array([0.5, 2.5]))
    same(d2.interp(**new), r2.interp(**new))
    np.testing.assert_allclose(d2.interp(**new).values, [[0.5, 2.5], [4.5, 6.5], [8.5, 10.5]])


def test_interp_out_of_bounds_nan(kind):
    da, ref = both(np.arange(4.0), kind, dims=("x",), coords={"x": [0.0, 1.0, 2.0, 3.0]})
    out = da.interp(x=[-1.0, 0.5, 4.0])
    same(out, ref.interp(x=[-1.0, 0.5, 4.0]))
    assert np.isnan(out.values[0]) and np.isnan(out.values[2]) and out.values[1] == 0.5
    with pytest.raises(ValueError, match="out of bounds"):
        da.interp(x=[4.0], bounds_error=True)


def test_arithmetic_broadcast_by_name(kind):
    rng = np.random.default_rng(1)
    (a, ra), (b, rb) = (both(rng.uniform(1, 2, (2, 3)), kind, dims=("line", "sample")),
                        both(rng.uniform(1, 2, 3), kind, dims=("sample",)))
    ops = [lambda x, y: x + y, lambda x, y: y * x, lambda x, y: x - y, lambda x, y: x / y,
           lambda x, y: x ** y, lambda x, y: 2.0 - x, lambda x, y: 2.0 / x, lambda x, y: 2.0 ** x,
           lambda x, y: 1.5 + x, lambda x, y: 1.5 * x, lambda x, y: x ** 2, lambda x, y: -x,
           lambda x, y: abs(x - 1.5), lambda x, y: x < y, lambda x, y: x <= 1.5,
           lambda x, y: x > y, lambda x, y: x >= 1.5]
    for op in ops:
        got = op(a, b)
        same(got, op(ra, rb))
        assert kind_of(got) == kind
    assert (a + b).dims == ("line", "sample") and (b * a).dims == ("sample", "line")
    # a numpy operand joins a tensor payload, and the other way round
    same(a + np.asarray(rb.data), ra + np.asarray(rb.data))
    mixed = a + DimArray(np.asarray(rb.data), dims=("sample",))
    same(mixed, ra + rb)
    assert kind_of(mixed) == kind
    # % (the port's own: the direction wraps need it on a DimArray)
    np.testing.assert_array_equal(((a - 1.5) % 0.25).values, (np.asarray(ra.data) - 1.5) % 0.25)


def test_broadcast_like(kind):
    big, rbig = both(np.zeros((4, 5)), kind, dims=("line", "sample"),
                     coords={"line": np.arange(4), "sample": np.arange(5)})
    row, rrow = both(np.arange(5.0), kind, dims=("sample",), coords={"sample": np.arange(5)})
    out = row.broadcast_like(big)
    same(out, rrow.broadcast_like(rbig))
    assert out.shape == (4, 5)
    np.testing.assert_array_equal(out.values[2], np.arange(5.0))
    rng = np.random.default_rng(2)
    e, re_ = both(rng.normal(size=(3,)), kind, dims=("x",))
    same(e.expand_dims(["a", "b"]), re_.expand_dims(["a", "b"]))
    same(e.expand_dims("a", axis=1), re_.expand_dims("a", axis=1))


def test_coarsen_trim(kind):
    kw = dict(dims=("line", "sample"), coords={"line": np.arange(5.0), "sample": np.arange(6.0)})
    da, ref = both(np.arange(30.0).reshape(5, 6), kind, **kw)
    out = da.coarsen_mean({"line": 2, "sample": 2})
    same(out, ref.coarsen_mean({"line": 2, "sample": 2}), rtol=1e-12 if kind == "tensor" else 0)
    assert out.shape == (2, 3)
    np.testing.assert_allclose(out.values[0, 0], np.mean([0, 1, 6, 7]))
    np.testing.assert_allclose(out.coords["line"], [0.5, 2.5])
    np.testing.assert_array_equal(blocked_coord_mean(np.arange(7.0), 3), [1.0, 4.0])
    with pytest.raises(NotImplementedError):
        da.coarsen_mean({"line": 2}, boundary="pad")


def test_reductions_and_pad(kind):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(4, 5, 6))
    data[1, 2, 3] = np.nan
    kw = dict(dims=("a", "b", "c"), coords={"a": np.arange(4.0), "c": np.arange(6.0)})
    da, ref = both(data, kind, **kw)
    rtol = 1e-12 if kind == "tensor" else 0
    for name in ("mean", "nanmean", "sum", "min", "max"):
        for dim in ("b", ("a", "c")):
            same(getattr(da, name)(dim), getattr(ref, name)(dim),
                 rtol=rtol if name in ("mean", "nanmean", "sum") else 0)
        whole, rwhole = getattr(da, name)(), getattr(ref, name)()
        np.testing.assert_allclose(np.asarray(whole), np.asarray(rwhole), rtol=1e-12)
    clean, rclean = both(np.nan_to_num(data), kind, **kw)
    same(clean.argmax("b"), rclean.argmax("b"))
    for mode in ("wrap", "reflect", "symmetric", "edge", "constant"):
        widths = {"a": 2, "c": (1, 3)}
        same(clean.pad(widths, mode=mode), rclean.pad(widths, mode=mode))
    assert "a" not in clean.pad({"a": 2}).coords and "c" in clean.pad({"a": 2}).coords
    ints, rints = both(np.arange(6).reshape(2, 3), kind, dims=("x", "y"))
    np.testing.assert_array_equal(ints.mean("y").values, np.asarray(rints.mean("y").data))


def test_to_device_numpy_pickle_and_copy(kind):
    da = port(LUT, kind, name="lut", **LUT_KW)
    moved = da.to("cpu")
    assert isinstance(moved.data, torch.Tensor) and moved.data.device.type == "cpu"
    back = moved.numpy()
    assert isinstance(back.data, np.ndarray)
    for other in (moved, back, pickle.loads(pickle.dumps(da)), copy.copy(da),
                  copy.deepcopy(da)):
        assert other.dims == da.dims and other.attrs == da.attrs and other.name == "lut"
        np.testing.assert_array_equal(other.values, LUT)
        np.testing.assert_array_equal(other.phi, da.coords["phi"])
    assert kind_of(pickle.loads(pickle.dumps(da))) == kind
    assert da.astype(np.float32).values.dtype == np.float32
    if kind == "tensor":  # a tensor payload also takes a torch dtype
        assert da.astype(torch.float32).values.dtype == np.float32
    with pytest.raises(TypeError):
        hash(da)  # elementwise == makes it unhashable, as the JAX class


def test_transpose_and_squeeze(kind):
    da, ref = both(LUT, kind, **LUT_KW)
    same(da.transpose("wspd", "phi", "incidence"), ref.transpose("wspd", "phi", "incidence"))
    same(da.transpose(), ref.transpose())
    one, rone = da.isel(incidence=slice(0, 1)), ref.isel(incidence=slice(0, 1))
    same(one.squeeze("incidence"), rone.squeeze("incidence"))
    same(one.squeeze(), rone.squeeze())
    with pytest.raises(ValueError, match="squeeze"):
        da.squeeze("wspd")
    renamed = da.rename("s0", phi="azimuth")
    assert renamed.name == "s0" and renamed.dims[-1] == "azimuth" and "azimuth" in renamed.coords
    same(da.assign_coords(wspd=[4, 5, 6]).drop_coords("phi"),
         ref.assign_coords(wspd=[4, 5, 6]).drop_coords("phi"))
    assert da.coord_spacing("phi") == ref.coord_spacing("phi") == 90.0


def test_where_fillna(kind):
    da, ref = both(np.array([1.0, np.nan, 3.0]), kind, dims=("x",))
    same(da.fillna(0.0), ref.fillna(0.0))
    same(da.where(da > 2.0), ref.where(ref > 2.0))
    same(da.where(da > 2.0, -1.0), ref.where(ref > 2.0, -1.0))
    same(da.where(np.array([True, False, True])), ref.where(np.array([True, False, True])))
    z, rz = both(np.array([1 + 1j, np.nan + 0j, 2j]), kind, dims=("x",))
    same(z.fillna(0.0), rz.fillna(0.0))


def test_interp_descending_coord(kind):
    kw = dict(dims=("x",), coords={"x": np.array([30.0, 20.0, 10.0])})
    da, ref = both(np.array([3.0, 2.0, 1.0]), kind, **kw)
    same(da.interp(x=np.array([25.0, 15.0])), ref.interp(x=np.array([25.0, 15.0])))
    np.testing.assert_allclose(da.interp(x=np.array([25.0, 15.0])).values, [2.5, 1.5])
    assert np.isnan(da.interp(x=np.array([35.0, 5.0])).values).all()


def test_interp_integer_data_promotes(kind):
    da = port(np.array([0, 10], dtype=np.int32), kind, dims=("x",), coords={"x": [0.0, 1.0]})
    out = da.interp(x=np.array([0.5]))
    assert np.issubdtype(out.values.dtype, np.floating)
    np.testing.assert_allclose(out.values, [5.0])
    assert np.isnan(da.interp(x=np.array([2.0])).values).all()


def test_elementwise_eq_ne(kind):
    da, ref = both(LUT, kind, **LUT_KW)
    same(da == 5.0, ref == 5.0)
    same(da != 5.0, ref != 5.0)
    same(da == da, ref == ref)
    assert (da == 5.0).values.sum() == 1 and (da != 5.0).values.sum() == LUT.size - 1


def test_where_aligns_transposed_mask(kind):
    data = np.arange(9, dtype=float).reshape(3, 3)
    c = [0.0, 1.0, 2.0]
    da, ref = both(data, kind, dims=("line", "sample"), coords={"line": c, "sample": c})
    mask, rmask = both(data.T > 4, kind, dims=("sample", "line"),
                       coords={"sample": c, "line": c})
    same(da.where(mask, -1.0), ref.where(rmask, -1.0))
    np.testing.assert_array_equal(da.where(mask, -1.0).values, np.where(data > 4, data, -1.0))


def test_dataset_sel_raises_on_coordless_dim(kind):
    a, ra = both(np.arange(3.0), kind, dims=("line",), coords={"line": [0., 1., 2.]})
    b = port(np.arange(3.0), kind, dims=("line",), coords={})
    with pytest.raises(KeyError, match="no coordinate"):
        DimDataset({"a": a, "b": b}).sel(line=1.0)
    ds, rds = DimDataset({"a": a, "c": a * 2.0}, attrs={"k": 1}), \
        JDimDataset({"a": ra, "c": ra * 2.0}, attrs={"k": 1})
    assert "a" in ds and ds.dims == rds.dims == {"line": 3} and ds.attrs == {"k": 1}
    for op in (lambda d: d.sel(line=1.0), lambda d: d.isel(line=slice(1, 3)),
               lambda d: d.interp(line=[0.5, 1.5]), lambda d: d.expand_dims("pol"),
               lambda d: d.assign_coords(line=[5., 6., 7.]), lambda d: d.mean("line"),
               lambda d: d.mean(["line", "absent"])):
        got, want = op(ds), op(rds)
        for k in ("a", "c"):
            same(got[k], want[k], rtol=1e-12)
    same(ds.c, rds.c)  # variables as attributes
    ds["d"] = b
    assert "d" in ds.variables and "DimDataset" in repr(ds)


def test_dataset_concat_existing_dim(kind):
    def mk(cls, arr_of, vals, coord):
        return cls({"v": arr_of(np.asarray(vals, float), dims=("line",), coords={"line": coord})})

    def port_of(data, **kw):
        return port(data, kind, **kw)

    parts = ([1, 2], [0., 1.]), ([3], [2.])
    out = DimDataset.concat([mk(DimDataset, port_of, *p) for p in parts], "line")
    ref = JDimDataset.concat([mk(JDimDataset, JDimArray, *p) for p in parts], "line")
    same(out["v"], ref["v"])
    np.testing.assert_array_equal(out["v"].values, [1., 2., 3.])
    assert kind_of(out["v"]) == kind
    parts = ([1, 2], [0., 1.]), ([3, 4], [0., 1.])
    out2 = DimDataset.concat([mk(DimDataset, port_of, *p) for p in parts], "pol")
    ref2 = JDimDataset.concat([mk(JDimDataset, JDimArray, *p) for p in parts], "pol")
    same(out2["v"], ref2["v"])
    assert out2["v"].dims == ("pol", "line")


def test_chunked_payload_stays_lazy(kind):
    """The constructor keeps a chunked duck array as it is (``is_chunked``);
    ``values`` and ``to`` read it whole only when asked."""
    from test_streaming import LazyRows

    base = np.arange(12.0).reshape(4, 3)
    lazy = LazyRows(lambda a, b: base[a:b], base.shape)
    assert is_chunked(lazy) and not is_chunked(base) and not is_chunked(torch.as_tensor(base))
    da = DimArray(lazy, dims=("line", "sample"))
    assert da.data is lazy and lazy.max_request == 0 and da.shape == (4, 3) and da.size == 12
    moved = da.to("cpu") if kind == "tensor" else da.numpy()
    assert kind_of(moved) == kind
    np.testing.assert_array_equal(moved.values, base)
