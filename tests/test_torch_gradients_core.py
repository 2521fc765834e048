"""The port's gradient core against the JAX package, on the CPU, in float64.

Inputs come from a numpy seed and go through the JAX function and the port's
counterpart. Tolerances:

* local gradients: rtol 1e-12 with atol 1e-14 of stencil sums added in the
  same order (``hypot``, ``atan2`` and ``sqrt`` may differ in the last bit);
* histograms: rtol 1e-9 with atol 1e-12. Both sides add exact per-pixel
  products in an unspecified order; where a pixel lands in another bin, the
  test shows that its ``k`` lies within 1e-9 of a half-integer (an ulp in the
  angle decides the rounding), and lets only such bins differ;
* windows, anchoring and ``used_ratio``: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xsarsea_tpu import gradients as JG
from xsarsea_tpu_torch import gradients as TG

from test_streaming import LazyRows

torch.set_num_threads(min(2, torch.get_num_threads()))

HIST_TOL = dict(rtol=1e-9, atol=1e-12)
BINS = TG._angle_bin_centers(72)


def streak_image(ny=256, nx=256, angle_deg=30.0, wavelength=20.0, seed=0):
    """Synthetic sigma0 with sinusoidal streaks at a known orientation."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx]
    k = 2 * np.pi / wavelength
    phase = k * (np.cos(np.deg2rad(angle_deg)) * x + np.sin(np.deg2rad(angle_deg)) * y)
    img = 1.0 + 0.5 * np.sin(phase) + 0.1 * r.normal(size=(ny, nx))
    return np.abs(img) + 0.01


def _t(a):
    return torch.as_tensor(np.asarray(a))


def assert_hist_close(got, ref, k=None, valid=None):
    """Histograms agree within HIST_TOL; when the per-pixel ``k`` (before
    rounding) is given, bins may differ where a valid pixel's k sits within
    1e-9 of a half-integer, and only there."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    close = np.isclose(got, ref, **HIST_TOL)
    if close.all():
        return
    assert k is not None, f"{(~close).sum()} bins differ"
    frac = np.abs(k - np.floor(k) - 0.5)
    on_the_edge = valid & (frac < 1e-9)
    for w in np.unique(np.nonzero(~close)[0]):
        assert on_the_edge.reshape(got.shape[0], -1)[w].any(), f"window {w} differs off a bin edge"


def test_bin_centers_and_coordinate_rules():
    np.testing.assert_array_equal(BINS, JG._angle_bin_centers(72))
    np.testing.assert_array_equal(TG._angle_bin_centers(36), JG._angle_bin_centers(36))
    c = np.arange(37) * 7.3 + 3.1
    np.testing.assert_array_equal(TG._r2_coord(c), JG._r2_coord(c))
    assert TG._coord_step(c) == JG._coord_step(c)
    coords = {"line": np.arange(230) * 7.3 + 3.1, "sample": np.arange(212) * 9.1}
    got, ref = TG._window_grid(coords, 150.0, 1), JG._window_grid(coords, 150.0, 1)
    for d in ("line", "sample"):
        np.testing.assert_array_equal(got[d], ref[d])
    spec_t, spec_j = TG._lg_window_spec(coords, 150.0, got), JG._lg_window_spec(coords, 150.0, ref)
    assert spec_t[0] == spec_j[0]
    np.testing.assert_array_equal(spec_t[1], spec_j[1])
    np.testing.assert_array_equal(spec_t[2], spec_j[2])
    with pytest.raises(ValueError, match="window_step"):
        TG._window_grid(coords, 150.0, 0.01)
    assert TG._LG_MARGIN_IN == JG._LG_MARGIN_IN


@pytest.mark.parametrize("shape", [(128, 130), (75, 66)])
def test_local_gradients_matches_jax(shape):
    img = streak_image(*shape)
    lg = TG.local_gradients(img, device="cpu")
    ref = JG.local_gradients(img)
    assert set(lg.variables) == {"G2_abs", "G2_angle", "G3", "c", "G2"}
    for name in ("G2_abs", "G2_angle", "G3", "c", "G2"):
        got = lg[name].values
        assert got.shape == (shape[0] // 2, shape[1] // 2) and lg[name].name == name
        np.testing.assert_allclose(got, np.asarray(ref[name].data), rtol=1e-12, atol=1e-14,
                                   err_msg=name)
        for d in ("line", "sample"):
            np.testing.assert_array_equal(lg[name].coords[d], ref[name].coords[d])
    assert lg["G2"].values.dtype == np.complex128
    # G2 is the principal square root of the pair the R2 cascades carried
    np.testing.assert_allclose(np.abs(lg["G2"].values), lg["G2_abs"].values, rtol=1e-13)
    f32 = TG.local_gradients(img.astype(np.float32), device="cpu")
    assert f32["G2"].values.dtype == np.complex64 and f32["c"].values.dtype == np.float32


def test_public_filters_match_jax():
    img = streak_image(64, 70)
    for name in ("R2", "smoothing", "Mean"):
        got, ref = getattr(TG, name)(img, device="cpu"), getattr(JG, name)(img)
        np.testing.assert_allclose(got.values, np.asarray(ref.data), rtol=1e-12, atol=1e-14)
        for d in ("line", "sample"):
            np.testing.assert_array_equal(got.coords[d], ref.coords[d])
    got = TG.convolve2d(img, TG.B2_KERNEL, boundary="wrap", device="cpu")
    np.testing.assert_allclose(got.values,
                               np.asarray(JG.convolve2d(img, JG.B2_KERNEL, boundary="wrap").data),
                               rtol=1e-12)
    # a tensor image is computed where it lives, no device named
    np.testing.assert_array_equal(TG.R2(torch.as_tensor(img)).values,
                                  TG.R2(img, device="cpu").values)


def _window_set():
    """Six windows of 100 px: plain, plain, NaN pixels, all NaN, zero pixels,
    an angle of exactly +pi/2 (and one of -pi/2)."""
    g2s, cs = [], []
    for seed in range(6):
        r = np.random.default_rng(seed)
        theta = r.uniform(-np.pi / 2 * 0.999, np.pi / 2 * 0.999, 100)
        if seed == 5:
            theta[3], theta[4] = np.pi / 2, -np.pi / 2
        g2 = r.uniform(0, 3, 100) * np.exp(1j * theta)
        if seed == 2:
            g2[::7] = np.nan + 1j * np.nan
        if seed == 3:
            g2[:] = np.nan + 1j * np.nan
        if seed == 4:
            g2[::5] = 0.0
        g2s.append(g2)
        cs.append(r.uniform(0, 1, 100))
    g2, c = np.stack(g2s), np.stack(cs)
    ang = np.angle(g2)
    ang[5, 3] = np.pi / 2  # exactly the upper edge: k == n_angles before the clip
    return np.abs(g2), ang, c


def test_histogram_windows_matches_jax():
    abs_w, ang_w, c_w = _window_set()
    got_h, got_r = TG._histogram_windows(_t(abs_w), _t(ang_w), _t(c_w), _t(BINS))
    ref_h, ref_r = JG._histogram_windows(jnp.asarray(abs_w), jnp.asarray(ang_w),
                                         jnp.asarray(c_w), jnp.asarray(BINS))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), **HIST_TOL)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))
    got_h, got_r = got_h.numpy(), got_r.numpy()
    assert got_h.shape == (6, 72) and (got_h[3] == 0).all() and got_r[3] == 0.0
    assert got_r[4] == 0.8 and got_r[0] == 1.0 and np.isfinite(got_h).all()
    # the +pi/2 pixel went into the last bin, the -pi/2 pixel into the first
    r5 = abs_w[5] / (abs_w[5] + np.median(abs_w[5]))
    assert got_h[5, 71] >= (r5 * c_w[5])[3] * (1 - 1e-12)
    # ``total``: the denominator of used_ratio for clipped slabs
    _, r_tot = TG._histogram_windows(_t(abs_w), _t(ang_w), _t(c_w), _t(BINS), total=400)
    np.testing.assert_array_equal(
        r_tot.numpy(), np.asarray(JG._histogram_windows(
            jnp.asarray(abs_w), jnp.asarray(ang_w), jnp.asarray(c_w), jnp.asarray(BINS),
            total=400)[1]))
    # float32 in, float32 out
    h32, r32 = TG._histogram_windows(*(_t(a.astype(np.float32)) for a in (abs_w, ang_w, c_w)),
                                     _t(BINS))
    assert h32.dtype == torch.float32 and r32.dtype == torch.float32
    np.testing.assert_allclose(h32.numpy(), got_h, atol=1e-5)


def test_gradient_histogram_single_window():
    r = np.random.default_rng(0)
    theta = r.uniform(-np.pi / 2 * 0.999, np.pi / 2 * 0.999, (10, 10))
    g2 = r.uniform(0, 3, (10, 10)) * np.exp(1j * theta)
    c = r.uniform(0, 1, (10, 10))
    h, ratio = TG.gradient_histogram(g2, c, BINS, device="cpu")
    h_ref, ratio_ref = JG.gradient_histogram(g2, c, BINS)
    assert isinstance(h, np.ndarray) and isinstance(ratio, float)
    np.testing.assert_allclose(h, h_ref, **HIST_TOL)
    assert ratio == ratio_ref == 1.0


def test_extract_windows_anchoring():
    arr = np.arange(100.0).reshape(10, 10)
    for w, sl in ((4, slice(3, 7)), (5, slice(3, 8))):  # even and odd: start = c - w//2
        wins = TG._extract_windows(_t(arr), [5], [5], w, w).numpy()
        np.testing.assert_array_equal(wins[0], arr[sl, sl].reshape(-1))
        np.testing.assert_array_equal(
            wins, np.asarray(JG._extract_windows(jnp.asarray(arr), jnp.asarray([5]),
                                                 jnp.asarray([5]), w, w)))
    # border window: center 0, w=4 covers [-2, 1] -> 2 x 2 real values
    wins0 = TG._extract_windows(_t(arr), [0], [0], 4, 4).numpy()
    assert np.isnan(wins0[0]).sum() == 4 * 4 - 2 * 2
    # complex payloads get complex NaNs
    z = TG._extract_windows(_t(arr + 1j * arr), [0], [9], 4, 4)
    assert z.dtype == torch.complex128 and torch.isnan(z.real).sum() == torch.isnan(z.imag).sum()


@pytest.mark.parametrize("w", [6, 7, 50])  # even, odd, larger than the grid
def test_extract_windows_batched_matches_unbatched_and_jax(w):
    rng = np.random.default_rng(4)
    chans = [rng.normal(size=(33, 41)).astype(np.float32) for _ in range(3)]
    chans[0][5:9, 7:12] = np.nan  # NaNs in the data itself survive
    cl = np.array([0, 7, 16, 30], dtype=np.int32)
    cs = np.array([2, 20, 40], dtype=np.int32)
    batched = TG._extract_windows(_t(np.stack(chans)), cl, cs, w, w)
    assert batched.shape == (12, 3, min(w, 33) * min(w, 41))
    ref = np.asarray(JG._extract_windows(jnp.asarray(np.stack(chans)), jnp.asarray(cl),
                                         jnp.asarray(cs), w, w))
    np.testing.assert_array_equal(batched.numpy(), ref)
    for k, ch in enumerate(chans):
        single = TG._extract_windows(_t(ch), _t(cl), _t(cs), w, w)
        np.testing.assert_array_equal(batched[:, k, :].numpy(), single.numpy())
        assert batched[:, k, :].is_contiguous()


def _k_of(img, cl, cs, window):
    """Per-pixel k before rounding and the valid mask, per window (float64)."""
    g2_abs, g2_angle, _ = TG._streaks_lg(_t(img))
    w = TG._extract_windows(torch.stack([g2_abs, g2_angle]), cl, cs, window, window).numpy()
    step = BINS[1] - BINS[0]
    valid = ~np.isnan(w[:, 0]) & (w[:, 0] > 0)
    return (w[:, 1] - BINS[0]) / step, valid


@pytest.mark.parametrize("shape,window", [((256, 256), 16), ((130, 171), 9), ((96, 80), 40)])
def test_streaks_histogram_core_matches_jax(shape, window):
    img = streak_image(*shape, angle_deg=25.0, seed=shape[0])
    n_l, n_s = shape[0] // 4, shape[1] // 4
    cl = np.arange(0, n_l, max(1, window // 2), dtype=np.int32)
    cs = np.arange(0, n_s, max(1, window // 2), dtype=np.int32)
    got_h, got_r = TG.streaks_histogram_core(img, cl, cs, window, BINS, device="cpu")
    ref_h, ref_r = JG.streaks_histogram_core(jnp.asarray(img), jnp.asarray(cl), jnp.asarray(cs),
                                             window, jnp.asarray(BINS))
    assert got_h.shape == (len(cl) * len(cs), 72)
    assert_hist_close(got_h.numpy(), ref_h, *_k_of(img, cl, cs, window))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))
    # the three stages one by one equal the core (the batched lg call included)
    g2_abs, g2_angle, c = (t[0] for t in TG._streaks_lg_batched(_t(img)))
    h, r = TG._windows_hist_fused(g2_abs, g2_angle, c, cl, cs, window, _t(BINS))
    np.testing.assert_array_equal((h / (window * window)).numpy(), got_h.numpy())
    np.testing.assert_array_equal(torch.nan_to_num(r).numpy(), got_r.numpy())


def test_streaks_lg_batched_equals_unbatched():
    a, b = streak_image(96, 80, seed=1), streak_image(96, 80, seed=2) * 0.3
    stacked = TG._streaks_lg_batched(_t(a), _t(b))
    for k, img in enumerate((a, b)):
        for got, ref, jref in zip(stacked, TG._streaks_lg(_t(img)),
                                  JG._streaks_lg(jnp.asarray(img))):
            np.testing.assert_array_equal(got[k].numpy(), ref.numpy())
            np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=1e-12, atol=1e-14)


def _banded_case(ny, nx, seed, slope):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    img = (1.0 + 0.4 * np.sin(0.25 * (xx + slope * yy))
           + 0.1 * rng.normal(size=(ny, nx))).astype(np.float64) ** 2
    lg_line = np.arange((ny // 2) // 2) * 4.0 + 1.5
    lg_sample = np.arange((nx // 2) // 2) * 4.0 + 1.5
    at_l, at_s = np.arange(ny, dtype=float)[::64], np.arange(nx, dtype=float)[::64]
    cl = np.abs(lg_line[None, :] - at_l[:, None]).argmin(axis=1)
    cs = np.abs(lg_sample[None, :] - at_s[:, None]).argmin(axis=1)
    return img, cl, cs


@pytest.mark.parametrize("ny", [501, 502, 503, 504])
def test_banded_streaks_hist_unaligned_heights(ny):
    """ny % 4 != 0: the bottom band must still end exactly at the image edge.
    Every band asks its source for one bounded slice, the same as the JAX
    routine asks for, and the result equals the whole-image core's."""
    nx = 168
    img, cl, cs = _banded_case(ny, nx, 5, 0.8)
    whole_h, whole_r = TG.streaks_histogram_core(img, cl, cs, 16, BINS, device="cpu")
    lazy = LazyRows(lambda a, b: img[a:b], img.shape)
    h, r = TG._banded_streaks_hist(lazy, cl, cs, 16, BINS, max_block_px=180 * nx, device="cpu")
    assert isinstance(h, torch.Tensor) and h.shape == (len(cl) * len(cs), 72)
    k, valid = _k_of(img, cl, cs, 16)
    assert_hist_close(h.numpy(), whole_h.numpy(), k, valid)
    np.testing.assert_array_equal(r.numpy(), whole_r.numpy())
    assert 0 < lazy.max_request < img.size  # streamed in bounded bands
    lazy_j = LazyRows(lambda a, b: img[a:b], img.shape)
    hj, rj = JG._banded_streaks_hist(lazy_j, cl, cs, 16, BINS, max_block_px=180 * nx)
    assert_hist_close(h.numpy(), hj, k, valid)
    np.testing.assert_array_equal(r.numpy(), rj)
    assert lazy.max_request == lazy_j.max_request


def test_banded_streaks_hist_unsorted_centers_and_one_band():
    ny, nx = 504, 240
    img, cl, cs = _banded_case(ny, nx, 9, 0.7)
    perm = np.array([3, 0, 6, 1, 7, 2, 5, 4])[:len(cl)]
    assert len(perm) == len(cl)
    whole_h, whole_r = TG.streaks_histogram_core(img, cl[perm], cs, 16, BINS, device="cpu")
    lazy = LazyRows(lambda a, b: img[a:b], img.shape)
    h, r = TG._banded_streaks_hist(lazy, cl[perm], cs, 16, BINS, max_block_px=180 * nx,
                                   device="cpu")
    assert_hist_close(h.numpy(), whole_h.numpy(), *_k_of(img, cl[perm], cs, 16))
    np.testing.assert_array_equal(r.numpy(), whole_r.numpy())
    assert 0 < lazy.max_request <= 184 * nx  # one band's rows, never the image
    hj, _ = JG._banded_streaks_hist(LazyRows(lambda a, b: img[a:b], img.shape), cl[perm], cs, 16,
                                    BINS, max_block_px=180 * nx)
    assert_hist_close(h.numpy(), hj, *_k_of(img, cl[perm], cs, 16))
    # a budget that holds the image: one band, one request, the core's own bits
    lazy1 = LazyRows(lambda a, b: img[a:b], img.shape)
    h1, r1 = TG._banded_streaks_hist(lazy1, cl, cs, 16, BINS, device="cpu")
    ref_h, ref_r = TG.streaks_histogram_core(img, cl, cs, 16, BINS, device="cpu")
    np.testing.assert_array_equal(h1.numpy(), ref_h.numpy())
    np.testing.assert_array_equal(r1.numpy(), ref_r.numpy())
    assert lazy1.max_request == img.size


def test_multiscale_hist_fused_shapes_and_values():
    base = np.stack([streak_image(160, 144, seed=1), streak_image(160, 144, seed=2) * 0.2])
    factors, spec = (1, 2), ((0, 10), (0, 16), (1, 5), (1, 8))
    cl = [np.array([0, 10, 30]), np.array([0, 10, 30]), np.array([0, 5, 15]),
          np.array([0, 5, 15])]
    cs = [np.array([4, 20]), np.array([4, 20]), np.array([2, 10]), np.array([2, 10])]
    w, r = TG._multiscale_hist_fused(_t(base), tuple(cl), tuple(cs), _t(BINS), factors, spec)
    assert w.shape == (2, 2, 2, 3, 2, 72) and r.shape == (2, 2, 2, 3, 2)
    wj, rj = JG._multiscale_hist_fused(
        jnp.asarray(base), tuple(jnp.asarray(c.astype(np.int32)) for c in cl),
        tuple(jnp.asarray(c.astype(np.int32)) for c in cs), jnp.asarray(BINS), factors, spec)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), **HIST_TOL)
    np.testing.assert_array_equal(r.numpy(), np.asarray(rj))
