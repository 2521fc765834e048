"""The port's stencils and resamplings against the JAX package, on the CPU.

The cases of tests/test_conv2d.py re-aimed: the JAX functions are the oracle
(they are held to scipy and OpenCV there). Both sides run in float64 on the
same numpy inputs. Tolerance: rtol 1e-12 with atol 1e-14 — the separable
stencils add their taps in the same order on both sides and agree to the
last bit or two; the full 2-D sum of a kernel that does not factorize runs
in another order than XLA's convolution. In float32 the port stays within
1e-5 of its own float64 result, relative to the largest value.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu.ops import conv2d as J
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.ops import conv2d as T

torch.set_num_threads(min(2, torch.get_num_threads()))

rng = np.random.default_rng(0)
IMG = rng.uniform(0.01, 1.0, size=(37, 53))
TOL = dict(rtol=1e-12, atol=1e-14)
BOUNDARIES = ("symm", "reflect101", "fill", "wrap")


def _np(t):
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    return t.numpy()


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_conv2d_same_every_boundary(boundary):
    for k in (J.B2_KERNEL, J.B4_KERNEL, J.B42_KERNEL, J.SCHARR_X):
        np.testing.assert_array_equal(getattr(T, "B2_KERNEL"), J.B2_KERNEL)
        got = _np(T.conv2d_same(IMG, k, boundary=boundary, device="cpu"))
        np.testing.assert_allclose(got, np.asarray(J.conv2d_same(IMG, k, boundary=boundary)),
                                   **TOL)
    # a fill value other than 0 takes the full 2-D sum
    got = _np(T.conv2d_same(IMG, J.B4_KERNEL, boundary="fill", fillvalue=0.3, device="cpu"))
    np.testing.assert_allclose(
        got, np.asarray(J.conv2d_same(IMG, J.B4_KERNEL, boundary="fill", fillvalue=0.3)), **TOL)


def test_kernel_constants_match():
    for name in ("B2_KERNEL", "B4_KERNEL", "B22_KERNEL", "B42_KERNEL", "SCHARR_X", "SCHARR_Y"):
        np.testing.assert_array_equal(getattr(T, name), getattr(J, name))


@pytest.mark.parametrize("shape", [(4, 4), (2, 3), (4, 5), (5, 4), (2, 2), (3, 3)])
@pytest.mark.parametrize("correlate", [False, True])
def test_conv2d_same_odd_and_even_kernels(shape, correlate):
    """Even kernel dims take the k//2-before pad split; random kernels do not
    factorize and take the full 2-D sum."""
    k = np.random.default_rng(sum(shape)).normal(size=shape)
    for boundary in BOUNDARIES:
        got = _np(T.conv2d_same(IMG, k, boundary=boundary, correlate=correlate, device="cpu"))
        ref = np.asarray(J.conv2d_same(IMG, k, boundary=boundary, correlate=correlate))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    # a rank-1 even kernel takes the separable passes
    sep = np.outer([1.0, 2.0, 2.0, 1.0], [0.5, 1.0])
    np.testing.assert_allclose(_np(T.conv2d_same(IMG, sep, device="cpu")),
                               np.asarray(J.conv2d_same(IMG, sep)), **TOL)


def test_conv2d_complex():
    z = IMG + 1j * IMG[::-1]
    got = _np(T.conv2d_same(z, J.B2_KERNEL, boundary="symm", device="cpu"))
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, np.asarray(J.conv2d_same(z, J.B2_KERNEL, boundary="symm")),
                               rtol=1e-12)


def test_integer_images():
    """An integer image keeps its dtype under an integer-valued kernel (the
    full kernel, not its fractional rank-1 factors) and promotes to float in
    the resamplings, whose weights an integer dtype would truncate to 0/1."""
    img_i = (IMG * 1000).astype(np.int32)
    k = np.array([[1, 2], [2, 4]])
    got = _np(T.conv2d_same(img_i, k, device="cpu"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(J.conv2d_same(img_i, k)))
    img_u16 = (IMG * 1000).astype(np.uint16)
    for fn, shape in (("resize_area", (18, 26)), ("zoom_bilinear", (60, 71))):
        got = _np(getattr(T, fn)(img_u16, shape, device="cpu"))
        ref = np.asarray(getattr(J, fn)(img_u16, shape))
        assert got.dtype == np.float32 and got.max() > 1.0  # not the zeroed-out integer matmul
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_pad_wider_than_the_image():
    """B42 pads 8 a side: on a 3 x 4 image every mirrored mode must wrap
    around as often as numpy does."""
    tiny = IMG[:3, :4]
    np.testing.assert_allclose(_np(T.local_mean(tiny, device="cpu")),
                               np.asarray(J.local_mean(tiny)), **TOL)
    for boundary in BOUNDARIES:
        got = _np(T.conv2d_same(tiny, J.B42_KERNEL, boundary=boundary, device="cpu"))
        np.testing.assert_allclose(
            got, np.asarray(J.conv2d_same(tiny, J.B42_KERNEL, boundary=boundary)), **TOL)


def test_scharr_and_smoothers():
    for axis in (0, 1):
        np.testing.assert_allclose(_np(T.scharr(IMG, axis=axis, device="cpu")),
                                   np.asarray(J.scharr(IMG, axis=axis)), **TOL)
    np.testing.assert_allclose(_np(T.smooth_b2(IMG, device="cpu")), np.asarray(J.smooth_b2(IMG)),
                               **TOL)
    np.testing.assert_allclose(_np(T.local_mean(IMG, device="cpu")),
                               np.asarray(J.local_mean(IMG)), **TOL)


@pytest.mark.parametrize("shape", [(37, 53), (35, 51), (36, 52)])
def test_r2_reduce_trims_odd_sizes(shape):
    img = IMG[:shape[0], :shape[1]]
    got = _np(T.r2_reduce(img, device="cpu"))
    assert got.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(got, np.asarray(J.r2_reduce(img)), **TOL)


def test_coarsen2_mean_equals_dimarray_coarsen_mean():
    """``r2_reduce`` coarsens with ``coarsen2_mean`` and ``R2`` with
    ``DimArray.coarsen_mean``: the two must agree bit for bit, on numpy and
    tensor payloads, and with the JAX form."""
    got = _np(T.coarsen2_mean(np.arange(30.0).reshape(5, 6), device="cpu"))
    assert got.shape == (2, 3) and got[0, 0] == np.mean([0, 1, 6, 7])
    img = np.random.default_rng(3).normal(size=(41, 38)) * 1e3
    got = _np(T.coarsen2_mean(img, device="cpu"))
    np.testing.assert_array_equal(got, np.asarray(J.coarsen2_mean(img)))
    da = DimArray(img, dims=("line", "sample"))
    np.testing.assert_array_equal(got, da.coarsen_mean({"line": 2, "sample": 2}).data)
    np.testing.assert_array_equal(
        got, da.to("cpu").coarsen_mean({"line": 2, "sample": 2}).data.numpy())
    f32 = img.astype(np.float32)
    np.testing.assert_array_equal(
        _np(T.coarsen2_mean(f32, device="cpu")),
        DimArray(torch.as_tensor(f32), dims=("line", "sample")).coarsen_mean(
            {"line": 2, "sample": 2}).data.numpy())


@pytest.mark.parametrize("fn,shapes", [("resize_area", [(18, 26), (12, 17), (37, 53)]),
                                       ("zoom_bilinear", [(74, 106), (60, 71), (1, 1)])])
def test_resamplings(fn, shapes):
    for shape in shapes:
        got = _np(getattr(T, fn)(IMG, shape, device="cpu"))
        assert got.shape == shape and got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(getattr(J, fn)(IMG, shape)), **TOL)


def test_stack_of_images_equals_one_by_one():
    """Every function works on the last two axes: a stack gives each image's
    own result, bit for bit."""
    stack = np.stack([IMG, IMG[::-1] * 2.0, IMG ** 2])
    for fn in (lambda x: T.r2_reduce(x, device="cpu"), lambda x: T.scharr(x, 1, device="cpu"),
               lambda x: T.local_mean(x, device="cpu"),
               lambda x: T.conv2d_same(x, np.ones((2, 3)), boundary="wrap", device="cpu"),
               lambda x: T.resize_area(x, (18, 26), device="cpu")):
        whole = _np(fn(stack))
        for k in range(3):
            np.testing.assert_array_equal(whole[k], _np(fn(stack[k])))


def test_float32_within_1e5_of_float64_and_tf32_flag_restored():
    """float32 stays within 1e-5 of float64 (of the largest value), also when
    the caller has allowed TF32 matmuls, and the caller's flag survives."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for fn in (lambda x: T.r2_reduce(x, device="cpu"), lambda x: T.local_mean(x, device="cpu"),
                   lambda x: T.scharr(x, 0, device="cpu"),
                   lambda x: T.resize_area(x, (12, 17), device="cpu"),
                   lambda x: T.zoom_bilinear(x, (60, 71), device="cpu"),
                   lambda x: T.conv2d_same(x, rng.normal(size=(4, 5)) * 0 + 0.25, device="cpu")):
            ref = _np(fn(IMG))
            got = _np(fn(IMG.astype(np.float32)))
            assert got.dtype == np.float32
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_device_rule():
    """numpy in goes to ``device`` (the default asks for a card and raises
    without one); a tensor is computed where it lives."""
    t = torch.as_tensor(IMG)
    out = T.smooth_b2(t)  # no device named: the tensor's own
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), _np(T.smooth_b2(IMG, device="cpu")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.smooth_b2(IMG)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.resize_area(IMG, (10, 10))
