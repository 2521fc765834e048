"""xsarsea's L1 chain in one call of ``invert_from_model``: the crosspol
weight ``dsig_cr`` made on the device from the raw NESZ (``dsig_cr=<scheme>,
nesz_cr=<NESZ>``), held on the CPU to the plain float64 reference
(``tests/_prep_reference.py``), to the example's three calls
(``nesz_flattening``, ``get_dsig``, ``invert_from_model`` with the array),
and across piece sizes, on seeded 40 x 96 scenes with float64 tables.

Tolerances: the flattened NESZ and ``dsig_cr`` agree with the reference to
rtol 1e-9: the reference solves each row's normal equations, the port sums
about the row's means, and the two differ at ~1e-13 in float64. Against the
three calls the winds are bit-equal and ``dsig_cr`` agrees to rtol 1e-14:
the same float64 operations, where the CPU's vectorized and scalar loops of
``exp`` and ``pow`` may part in the last bit at a piece's tail. Against the
reference the winds are judged by the benchmark's judge with the reference's
``dsig_cr``: every copol and crosspol cost at the grid's least to 1e-6, no
NaN or merge out of place. The judge takes the least copol cost with
``dsig_co`` in float32 and the chosen cell's in float64, ~1e-8 apart on the
same cell; a neighbouring cell costs ~1e-2 more.
"""

import numpy as np
import pytest
import torch

import _prep_reference as ref
from benchmark.reference.judge import Judge, sample_inputs_f64
from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.utils.spans import counters
from xsarsea_tpu_torch.windspeed import get_dsig, invert_from_model, nesz_flattening
from xsarsea_tpu_torch.windspeed.dsig import nesz_expand
from xsarsea_tpu_torch.windspeed.inversion import _LazySource, _pieces, prepare_tables

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = ("gmf_cmod5n", "gmf_s1_v2")
KW = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
SCHEME = "gmf_s1_v2"
NY, NX = 40, 96
RTOL_REF = 1e-9
RTOL_THREE = 1e-14
GAP_TOL = 1e-6
NEW_COUNTERS = ("nesz_rows", "nesz_rows_nan", "dsig_px")


def scene(seed, inc_form="full", rows=()):
    """A dual-pol scene and its raw VH NESZ: incidence 30-46 deg, sigma0
    forward-modelled from a random wind, 20 NaN NESZ samples and a coastal
    block of NaN copol sigma0. ``rows``: ``"nan"`` makes row 7 of the NESZ
    all NaN (the column means fill it), ``"zero"`` row 30 all 0 (no finite
    sample in dB: NaN weights), ``"f32"`` the NESZ float32, as an L1
    product's (the chain fits its float64 values)."""
    rng = np.random.default_rng(seed)
    vec = np.linspace(30.0, 46.0, NX)
    inc = vec[None, :] + rng.normal(0.0, 0.01, (NY, NX))
    speed = rng.uniform(3.0, 20.0, (NY, NX))
    phi = rng.uniform(0.0, 180.0, (NY, NX))
    t = [torch.as_tensor(a) for a in (inc, speed, phi)]
    s0_co = get_model(MODEL[0])(*t, broadcast=True).numpy() * rng.uniform(0.95, 1.05, (NY, NX))
    s0_cr = get_model(MODEL[1])(t[0], t[1], broadcast=True).numpy() \
        * rng.uniform(0.9, 1.1, (NY, NX))
    s0_co[5:12, :20] = np.nan
    third = np.arange(NX) * 3 // NX
    db = -25.0 + 0.1 * (inc - 30.0) + np.array([0.0, 1.0, -0.5])[third] \
        + rng.normal(0.0, 0.15, (NY, NX))
    nesz = 10.0 ** (db / 10.0)
    nesz.reshape(-1)[rng.choice(NY * NX, 20, replace=False)] = np.nan
    if "nan" in rows:
        nesz[7] = np.nan
    if "zero" in rows:
        nesz[30] = 0.0
    if "f32" in rows:
        nesz = nesz.astype(np.float32)
    anc_speed = speed + rng.normal(0.0, 1.5, (NY, NX))
    anc = anc_speed * np.exp(1j * np.deg2rad(phi + rng.normal(0.0, 20.0, (NY, NX))))
    return dict(inc=inc if inc_form == "full" else vec, s0_co=s0_co, s0_cr=s0_cr, nesz=nesz,
                anc=anc)


def chain(sc, tables_dtype=torch.float64, **kw):
    return invert_from_model(sc["inc"], sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"],
                             dsig_cr=SCHEME, nesz_cr=sc["nesz"], model=MODEL,
                             dtype=tables_dtype, device="cpu", **KW, **kw)


def three_calls(sc, tables_dtype=torch.float64, **kw):
    """The L1 example's three calls, with the incidence as the scene array."""
    inc = np.broadcast_to(sc["inc"], sc["s0_cr"].shape)
    flat = nesz_flattening(sc["nesz"].astype(np.float64), inc, device="cpu")
    dsig = get_dsig(SCHEME, inc, sc["s0_cr"], flat, device="cpu")
    winds = invert_from_model(sc["inc"], sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"],
                              dsig_cr=dsig, model=MODEL, dtype=tables_dtype, device="cpu",
                              **KW, **kw)
    return winds, flat, dsig


def pieces_of(sc, piece):
    """The chain's flattened NESZ and ``dsig_cr`` as its pieces make them."""
    src = _LazySource(sc["s0_cr"].shape, sc["inc"], s0_co=sc["s0_co"], s0_cr=sc["s0_cr"],
                      dsig_cr=SCHEME, anc=sc["anc"], device_db=False, nesz_cr=sc["nesz"])
    src.fit_nesz(torch.device("cpu"))
    w = src._weights
    flat, dsig = [], []
    for lo, hi in _pieces(src.n, piece):
        flat.append(nesz_expand(w.slope, w.intercept, w.inc_1d, lo, hi))
        dsig.append(src.streams(lo, hi, torch.device("cpu"), torch.float64)[3])
    return torch.cat(flat).numpy().reshape(NY, NX), torch.cat(dsig).numpy().reshape(NY, NX)


def assert_close(got, want, rtol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, equal_nan=True)


def same_bits(a, b):
    return np.array_equal(np.asarray(a).view(np.uint64), np.asarray(b).view(np.uint64))


# piece sizes that split rows (and a last piece of a few pixels), one whole
# scene; incidence as the scene array and as a vector; NaN and zero rows; a
# float32 NESZ
CASES = [
    (1000, "full", ()), (NY * NX, "full", ()), (777, "vector", ()),
    (NY * NX, "vector", ("nan", "zero")), (1000, "full", ("nan", "zero", "f32")),
]


@pytest.mark.parametrize("piece,inc_form,rows", CASES)
def test_chain_weights_match_the_reference(piece, inc_form, rows):
    sc = scene(11, inc_form, rows)
    flat, dsig = pieces_of(sc, piece)
    want_flat = ref.nesz_flattening(sc["nesz"], sc["inc"]).numpy()
    want_dsig = ref.dsig_from_nesz(SCHEME, sc["inc"], sc["s0_cr"], sc["nesz"]).numpy()
    assert_close(flat, want_flat, RTOL_REF)
    assert_close(dsig, want_dsig, RTOL_REF)
    assert np.isnan(dsig).any() == ("zero" in rows)
    assert np.isnan(dsig[30]).all() == ("zero" in rows)
    assert np.isfinite(dsig[7]).all()  # a NaN row is filled by its columns' means


@pytest.mark.parametrize("piece,inc_form,rows", CASES)
def test_chain_winds_equal_the_three_calls_and_the_reference(piece, inc_form, rows):
    sc = scene(12, inc_form, rows)
    before = counters()
    co, du = chain(sc, piece_size=piece)
    after = counters()
    (co3, du3), flat3, dsig3 = three_calls(sc, piece_size=piece)
    assert same_bits(co, co3) and same_bits(du, du3)
    flat, dsig = pieces_of(sc, piece)
    assert_close(flat, flat3, RTOL_THREE)
    assert_close(dsig, dsig3, RTOL_THREE)
    assert after.get("nesz_rows", 0) - before.get("nesz_rows", 0) == NY
    assert after.get("nesz_rows_nan", 0) - before.get("nesz_rows_nan", 0) == int("zero" in rows)
    assert after.get("dsig_px", 0) - before.get("dsig_px", 0) == NY * NX

    # judged with the reference's dsig_cr, as the benchmark judges a cell
    tables = prepare_tables(*MODEL, dtype=torch.float64, **KW)
    judge = Judge(tables, 0.1, torch.device("cpu"))
    inc = np.broadcast_to(sc["inc"], (NY, NX))
    x = sample_inputs_f64({
        "inc": inc.reshape(-1), "s0_co_db": 10.0 * np.log10(sc["s0_co"].reshape(-1) + 1e-15),
        "s0_cr_db": 10.0 * np.log10(sc["s0_cr"].reshape(-1) + 1e-15),
        "dsig_cr": ref.dsig_from_nesz(SCHEME, sc["inc"], sc["s0_cr"], sc["nesz"]).reshape(-1),
        "anc_re": sc["anc"].real.reshape(-1), "anc_im": sc["anc"].imag.reshape(-1)})
    verdict = judge.judge(x, torch.from_numpy(co.reshape(-1)), torch.from_numpy(du.reshape(-1)),
                          merged=True)
    assert not verdict["post_error"].any()
    assert float(verdict["co_gap"].max()) <= GAP_TOL
    assert float(verdict["dual_gap"].max()) <= GAP_TOL
    if "zero" in rows:  # no weight: crosspol invalid, the merge takes copol where it can
        co30, du30 = co[30], du[30]
        assert same_bits(du30[np.abs(co30) < 5.0], co30[np.abs(co30) < 5.0])
        assert np.isnan(du30[~(np.abs(co30) < 5.0)]).all()


def test_chain_is_the_same_for_every_piece_size():
    sc = scene(13)
    whole = chain(sc)
    for piece in (500, 1111, 2 * NX):
        got = chain(sc, piece_size=piece)
        assert all(same_bits(a, b) for a, b in zip(got, whole))


def test_chain_on_the_float32_fused_path_equals_the_three_calls():
    """The card's path on the CPU's plain kernels: float32 tables, sigma0
    in dB on the device from the same linear copy that the weights read."""
    sc = scene(14)
    got = chain(sc, tables_dtype=torch.float32, mode="fused", piece_size=1500)
    (co3, du3), _, _ = three_calls(sc, tables_dtype=torch.float32, mode="fused", piece_size=1500)
    assert same_bits(got[0].view(np.uint64), co3.view(np.uint64))
    assert same_bits(got[1].view(np.uint64), du3.view(np.uint64))


def test_an_array_dsig_call_records_no_chain_span_or_counter():
    sc = scene(15)
    (_, _, dsig) = three_calls(sc)
    before = counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        invert_from_model(sc["inc"], sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"],
                          dsig_cr=dsig, model=MODEL, dtype=torch.float64, device="cpu", **KW)
        invert_from_model(sc["inc"], sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"],
                          dsig_cr=0.1, model=MODEL, dtype=torch.float64, device="cpu", **KW)
    after = counters()
    names = {e.name for e in prof.events()}
    assert "xs.prep" in names and not names & {"xs.nesz", "xs.dsig"}
    assert all(after.get(k, 0) == before.get(k, 0) for k in NEW_COUNTERS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        chain(sc)
    assert {"xs.nesz", "xs.dsig"} <= {e.name for e in prof.events()}


@pytest.mark.parametrize("kwargs,match", [
    (dict(dsig_cr=SCHEME), "both a dsig scheme"),
    (dict(dsig_cr=0.1, nesz_cr="scene"), "both a dsig scheme"),
    (dict(dsig_cr="unknown", nesz_cr="scene"), "not handled"),
    (dict(dsig_cr=SCHEME, nesz_cr="row"), "shape of the scene"),
    (dict(dsig_cr=SCHEME, nesz_cr="scene", inc="scalar"), "along the samples"),
    (dict(dsig_cr=SCHEME, nesz_cr="scene", inc="line"), "along the samples"),
])
def test_chain_arguments_are_checked(kwargs, match):
    sc = scene(16)
    kwargs = dict(kwargs)
    nesz = {"scene": sc["nesz"], "row": sc["nesz"][0]}.get(kwargs.pop("nesz_cr", None))
    inc = {"scalar": 35.0, "line": sc["inc"][:, :1]}.get(kwargs.pop("inc", None), sc["inc"])
    with pytest.raises(ValueError, match=match):
        invert_from_model(inc, sc["s0_co"], sc["s0_cr"], ancillary_wind=sc["anc"],
                          nesz_cr=nesz, model=MODEL, dtype=torch.float64, device="cpu", **KW,
                          **kwargs)
