"""The dual-pol merge on the CPU: ``dual_merge``'s plain version against the
rule it defines, and the inversion's merging path around it.

* the plain version equals the rule on random winds, the rule's modulus
  computed here in numpy float64 and rounded once to float32;
* the seams: speeds planted at 5 m/s and one float32 ulp either side, along
  each axis and on the diagonal, in either wind;
* NaN in either wind, in ``re`` or ``im`` alone, and the guard's NaN + 0j;
  an empty piece;
* ``_invert_source(..., merge=True)`` gives the plain merge of its own
  unmerged winds, and its overlapped loop the serial loop's bits at three
  pieces; ``invert_from_model`` on the CPU merges on the host (counter
  ``merge_px_host``), never with the kernel.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.utils import spans
from xsarsea_tpu_torch.windspeed.inversion import (_invert_source, _LazySource,
                                                   invert_from_model, prepare_tables)

MODEL = ("gmf_cmod5n", "gmf_s1_v2")
KW = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
F32 = np.float32


def _rule(co, du):
    """The merge as defined: copol where either wind's float32 modulus,
    rounded once from float64, is below 5 m/s."""
    def below(w):
        re, im = w.real.astype(np.float64), w.imag.astype(np.float64)
        with np.errstate(invalid="ignore"):
            return np.sqrt(re * re + im * im).astype(F32) < F32(5)

    take = below(co) | below(du)
    return np.where(take, co, du), take


def _planes(w):
    return (torch.from_numpy(np.ascontiguousarray(w.real)),
            torch.from_numpy(np.ascontiguousarray(w.imag)))


def _merge(co, du):
    wind_co, wind_dual = K.dual_merge(*_planes(co), *_planes(du))
    assert wind_co.dtype == wind_dual.dtype == torch.complex64
    return wind_co.numpy(), wind_dual.numpy()


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _assert_rule(co, du):
    got_co, got_dual = _merge(co, du)
    want, take = _rule(co, du)
    np.testing.assert_array_equal(_bits(got_co), _bits(co))
    np.testing.assert_array_equal(_bits(got_dual), _bits(want))
    return take


def test_plain_merge_equals_the_rule_on_random_winds():
    rng = np.random.default_rng(0)
    n = 1 << 16
    co, du = ((rng.normal(0, 6, n) + 1j * rng.normal(0, 6, n)).astype(np.complex64)
              for _ in range(2))
    take = _assert_rule(co, du)
    assert 0.2 < take.mean() < 0.8  # both outcomes, many times


def _seams():
    """Winds whose float32 modulus lies at 5 m/s or one ulp either side:
    along each axis (either sign) and on the diagonal."""
    five = F32(5)
    radii = [np.nextafter(five, F32(0)), five, np.nextafter(five, F32(10))]
    winds = []
    for r in radii:
        winds += [complex(r, 0), complex(-r, 0), complex(0, r), complex(0, -r)]
    d = F32(5 / np.sqrt(2))
    for k in range(-3, 4):  # the diagonal's floats around 5 / sqrt(2)
        x = d
        for _ in range(abs(k)):
            x = np.nextafter(x, F32(np.sign(k) * 10))
        winds += [complex(x, x), complex(-x, x)]
    return np.array(winds, np.complex64)


@pytest.mark.parametrize("which", ["co", "du"])
def test_plain_merge_at_the_seams(which):
    seam = _seams()
    far = np.full(seam.shape, 10 + 0j, np.complex64)  # never below
    co, du = (seam, far) if which == "co" else (far, seam)
    take = _assert_rule(co, du)
    speed = np.abs(seam.astype(np.complex128))
    # the axes decide exactly: below one ulp under 5 m/s, not at 5 or above
    axis = (seam.real == 0) | (seam.imag == 0)
    np.testing.assert_array_equal(take[axis], speed[axis] < 5)
    diag = ~axis
    assert take[diag].any() and not take[diag].all()


def test_plain_merge_nan_winds():
    nan = np.nan
    slow, fast = 2 + 1j, 8 - 3j
    cases = [  # (co, du, takes the copol wind)
        (complex(nan, nan), slow, True),  # NaN copol, slow dual: the (NaN) copol wind
        (complex(nan, nan), fast, False),
        (slow, complex(nan, nan), True),
        (fast, complex(nan, nan), False),
        (complex(nan, 1.0), fast, False),  # re alone NaN
        (complex(1.0, nan), fast, False),  # im alone NaN
        (fast, complex(nan, 0.5), False),
        (slow, complex(0.5, nan), True),
        (complex(nan, 0.0), complex(nan, 0.0), False),  # the guard's NaN + 0j in both
        (complex(nan, 0.0), slow, True),
        (complex(nan, nan), complex(nan, nan), False),
    ]
    co = np.array([c for c, _, _ in cases], np.complex64)
    du = np.array([d for _, d, _ in cases], np.complex64)
    take = _assert_rule(co, du)
    np.testing.assert_array_equal(take, [t for _, _, t in cases])


def test_plain_merge_of_an_empty_piece():
    empty = np.zeros(0, np.complex64)
    wind_co, wind_dual = _merge(empty, empty)
    assert wind_co.shape == wind_dual.shape == (0,)


def test_dual_merge_refuses_other_devices():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.dual_merge(meta, meta, meta, meta)


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 25.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 ** ((-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)) / 10.0)
    s0_cr = 10 ** ((-35.0 + 0.6 * wspd - 0.1 * (inc - 30.0)) / 10.0)
    anc = wspd * np.exp(1j * np.deg2rad(phi))
    inc[0], s0_co[1], s0_cr[2], anc[3] = np.nan, np.nan, np.nan, np.nan
    return inc, s0_co, s0_cr, anc


@pytest.mark.parametrize("mode", ["fused", "exact"])
def test_merging_piece_loop_on_the_cpu(mode):
    """``merge=True``: each piece's winds through the plain ``dual_merge``;
    the overlapped loop equals the serial one bit for bit at three pieces."""
    n, piece = 3000, 1000
    inc, s0_co, s0_cr, anc = _scene(n, 5)
    tables = prepare_tables(*MODEL, dtype=torch.float32, **KW)

    def run(**kw):
        src = _LazySource((n,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc)
        return _invert_source(tables, src, mode=mode, device="cpu", piece_size=piece, **kw)

    co, du = run(_overlap=False)
    serial = run(merge=True, _overlap=False)
    np.testing.assert_array_equal(_bits(serial[0]), _bits(co))
    np.testing.assert_array_equal(_bits(serial[1]), _bits(_rule(co, du)[0]))
    for got, want in zip(run(merge=True), serial):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_invert_from_model_on_the_cpu_merges_on_the_host():
    n = 1200
    inc, s0_co, s0_cr, anc = _scene(n, 6)
    before = spans.counters()
    K.reset_launch_counts()
    co, dual = invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc, model=MODEL,
                                 dtype=torch.float32, mode="fused", device="cpu", **KW)
    after = spans.counters()
    assert after["merge_px_host"] - before["merge_px_host"] == n
    assert after["merge_px_card"] == before["merge_px_card"]
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)  # no dual_merge launch
    # numpy's merge: the copol wind where np.abs of either wind is below 5
    src = _LazySource((n,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc)
    raw_co, raw_du = _invert_source(prepare_tables(*MODEL, dtype=torch.float32, **KW), src,
                                    mode="fused", device="cpu")
    take = (np.abs(raw_co) < 5) | (np.abs(raw_du) < 5)
    np.testing.assert_array_equal(_bits(co), _bits(raw_co))
    np.testing.assert_array_equal(_bits(dual), _bits(np.where(take, raw_co, raw_du)))
