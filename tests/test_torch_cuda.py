"""The CUDA kernels on the card, against their plain PyTorch versions and
the exact path; the scene-preparation functions and the wind-streak path on
the card against their CPU runs; the overlapped piece loop on its streams
against the serial one; the fused_exact mode (K1's streamed form, 32-row
slabs) and a mesh naming the card twice; the CLI's ``invert`` on the card,
the profiler context's trace and ``PlotGradients``' peak against the CPU.
Needs a CUDA device and nvcc; skipped elsewhere.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu_torch import sigma0_detrend
from xsarsea_tpu_torch.dimarray import DimArray
from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.ops.coarse_seams import (coarse_seam_cases, crosspol_seam_cases,
                                                full_grid_seam_cases, fused_crosspol_seam_cases,
                                                prune_seam_cases, quotient_edge_set,
                                                quotient_random_set)
from xsarsea_tpu_torch.ops.slab_seams import seam_cases
from xsarsea_tpu_torch.windspeed import get_dsig, get_dsig_wspd, nesz_flattening
from xsarsea_tpu_torch.windspeed.inversion import InversionTables, invert_from_model, \
    invert_pixels, prepare_tables

from _bucket_copies import identity
from _parity import assert_equal_modulo_pi_ties

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(rng, n_inc=6, n_wspd=120, n_phi=181, n_cr=90):
    lut = rng.uniform(-35, 0, (n_inc, n_wspd, n_phi)).astype(np.float32)
    lut[1, 40, 10] = np.nan
    wspd = np.linspace(0.2, 50, n_wspd).astype(np.float32)
    phir = np.deg2rad(np.linspace(0, 180, n_phi)).astype(np.float32)
    u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np.float32)
    v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np.float32)
    crlut = rng.uniform(-40, -20, (n_inc, n_cr)).astype(np.float32)
    crw = np.linspace(3, 80, n_cr).astype(np.float32)
    return lut, wspd, phir, u, v, crlut, crw


def test_kernels_bit_equal_to_plain_versions(cuda):
    rng = np.random.default_rng(0)
    lut, wspd, phir, u, v, crlut, crw = _operands(rng)
    dev = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    K.reset_launch_counts()

    coarse = [dev(a) for a in K.build_coarse_arrays(lut, u, v, 4, 4)[:4]]
    n_groups = K.build_coarse_arrays(lut, u, v, 4, 4)[4]
    nb1 = 9
    feats1 = np.stack([rng.uniform(-30, -5, nb1 * 256), rng.uniform(-12, 12, nb1 * 256),
                       rng.uniform(0, 12, nb1 * 256), np.full(nb1 * 256, 10.0)], 1)
    feats1[5] = np.nan
    args1 = (*coarse, dev(feats1.astype(np.float32)), dev(rng.integers(0, 6, nb1)), n_groups)
    ix1 = identity(args1[4])  # rows in slot order
    got1 = K.group_argmin(*args1, index=ix1)
    ref1 = K._group_argmin_plain(*args1, block=256, index=ix1)
    assert torch.equal(got1, ref1)

    lut_pad, u_pad, v_pad = (dev(a) for a in K.build_direct_arrays(lut, u, v))
    wp = lut_pad.shape[1]
    nb2 = 11
    sband = rng.integers(0, 6, nb2).astype(np.int32)
    sband[0] = 1
    srow0 = np.clip(rng.integers(0, 8, nb2) * 16 - 16, 0, wp - 48).astype(np.int32)
    srow0[0] = 16
    n = nb2 * 128
    feats2 = np.stack([rng.uniform(-30, -5, n), rng.uniform(-12, 12, n), rng.uniform(0, 12, n),
                       np.full(n, 10.0), rng.uniform(-38, -22, n), rng.uniform(0.1, 1.0, n),
                       np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    feats2[3] = np.nan
    feats2[300, 0] = np.nan
    vmask = np.ones(nb2, np.int32)
    vmask[7] = 0
    args2 = (lut_pad, u_pad, v_pad, dev(K.build_decode_arrays(wspd, wp)), dev(phir),
             *(dev(a) for a in K.build_crosspol_arrays(crlut, crw)), dev(feats2), dev(sband),
             dev(srow0), dev(vmask))
    ix2 = identity(args2[7])
    got2 = K.slab_refine_fused(*args2, index=ix2)
    ref2 = K._slab_refine_fused_plain(*args2, has_cr=True, block=128, index=ix2)
    torch.cuda.synchronize()
    assert torch.equal(got2, ref2)
    assert (got2[0, :128] == 0).any()  # the NaN LUT entry poisons some of block 0's pixels
    assert K.launch_counts() == {**dict.fromkeys(K.KERNELS, 0), "group_argmin": 1,
                                 "slab_refine_fused": 1}


def test_k3_k4_bit_equal_to_plain_versions(cuda):
    """K3 (slab_refine) and K4 (crosspol_argmin) against their plain
    versions, sentinels included: a NaN LUT entry (2**30), a pixel with no
    finite cost (1/dsig = inf), padding slots and rows, skipped blocks, NaN
    crosspol inputs and has_co = 0."""
    rng = np.random.default_rng(3)
    lut, wspd, phir, u, v, crlut, crw = _operands(rng)
    dev = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    K.reset_launch_counts()
    lut_pad, u_pad, v_pad = (dev(a) for a in K.build_direct_arrays(lut, u, v))
    wp = lut_pad.shape[1]
    nb = 13
    sband = rng.integers(0, 6, nb).astype(np.int32)
    sband[0] = 1
    srow0 = np.clip(rng.integers(0, 8, nb) * 16 - 16, 0, wp - 48).astype(np.int32)
    srow0[0], srow0[1] = 16, wp - 48
    n = nb * 128
    feats = np.stack([rng.uniform(-30, -5, n), rng.uniform(-12, 12, n), rng.uniform(0, 12, n),
                      np.full(n, 10.0)], 1).astype(np.float32)
    feats[3] = np.nan
    feats[300, 3] = np.inf
    vmask = np.ones(nb, np.int32)
    vmask[7] = 0
    args3 = (lut_pad, u_pad, v_pad, dev(feats), dev(sband), dev(srow0), dev(vmask))
    ix3 = identity(args3[3])
    got3 = K.slab_refine(*args3, index=ix3)
    ref3 = K._slab_refine_plain(*args3, block=128, index=ix3)
    torch.cuda.synchronize()
    assert torch.equal(got3, ref3)
    assert (got3[:128] == 2 ** 30).any() and got3.reshape(-1)[3] == 2 ** 30
    assert got3.reshape(-1)[300] == ((2 ** 30 // 181) & ~1) * 181

    nb4 = 9
    n4 = nb4 * 256
    has_co = (rng.random(n4) < 0.8).astype(np.float32)
    feats4 = np.stack([rng.uniform(-38, -22, n4), rng.uniform(0.1, 1.0, n4),
                       has_co * rng.uniform(0, 20, n4), has_co], 1).astype(np.float32)
    feats4[5, 0] = np.nan
    feats4[6, 1] = np.nan
    feats4[-30:] = np.nan
    args4 = (*(dev(a) for a in K.build_crosspol_arrays(crlut, crw)), dev(feats4),
             dev(rng.integers(0, 6, nb4)))
    ix4 = identity(args4[2])
    got4 = K.crosspol_argmin(*args4, index=ix4)
    ref4 = K._crosspol_argmin_plain(*args4, block=256, index=ix4)
    torch.cuda.synchronize()
    assert torch.equal(got4, ref4)
    assert (got4.reshape(-1)[[5, 6]] == 0).all() and (got4.reshape(-1)[:5] > 0).all()
    assert K.launch_counts() == {**dict.fromkeys(K.KERNELS, 0), "slab_refine": 1,
                                 "crosspol_argmin": 1}


@pytest.mark.parametrize("n_phi", [37, 72, 181])
def test_k2_k3_bit_equal_to_plain_versions_on_the_sweeps_seams(cuda, n_phi):
    """K2 and K3 against their plain versions on the seam cases of their
    sweep (ops/slab_seams.py): ties across warps, chunks, float4s and the
    scalar tail (widths with and without one); padding that fills whole
    groups or ends mid-group; NaN-s0 pixels with valid crosspol in groups
    the sweep skips; NaN and +-inf LUT entries, 1/dsig = 0 and inf; a slab
    of padding rows only."""
    cases = seam_cases(n_phi=n_phi)
    K.reset_launch_counts()
    args2 = cases.k2_args(cuda)
    args3 = cases.k3_args(cuda)
    index = cases.index(cuda)
    got2 = K.slab_refine_fused(*args2, index=index)
    got3 = K.slab_refine(*args3, index=index)
    ref2 = K._slab_refine_fused_plain(*args2, has_cr=True, block=K.SLAB_BLOCK, index=index)
    ref3 = K._slab_refine_plain(*args3, block=K.SLAB_BLOCK, index=index)
    torch.cuda.synchronize()
    assert torch.equal(got2, ref2)
    assert torch.equal(got3, ref3)
    flat = got3.reshape(-1).cpu().numpy()
    assert all(flat[s] == e for s, e in cases.expected.items())
    assert K.launch_counts() == {**dict.fromkeys(K.KERNELS, 0), "slab_refine_fused": 1,
                                 "slab_refine": 1}


def _wrong(got, expected):
    return {s: (got[s], e) for s, e in expected.items() if got[s] != e}


@pytest.mark.parametrize("n_cols", [19, 46, 48])
def test_k1_bit_equal_to_plain_version_on_its_seams(cuda, n_cols):
    """K1 against its plain version and its designed answers on the seam
    cases of its sweep (ops/coarse_seams.py): equal group minima across and
    within its chains and pixel sets, the minimum beside the stride's NaN
    padding, NaN entries that neither win nor poison, pixels without a
    finite cost, padding groups; widths with and without padding."""
    cases = coarse_seam_cases(n_cols)
    K.reset_launch_counts()
    args = cases.args(cuda)
    got = K.group_argmin(*args, index=cases.index(cuda))
    ref = K._group_argmin_plain(*args, block=K.GROUP_BLOCK, index=cases.index(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert not _wrong(got.reshape(-1).cpu().numpy(), cases.expected)
    assert K.launch_counts() == {**dict.fromkeys(K.KERNELS, 0), "group_argmin": 1}


@pytest.mark.parametrize("n_cr", [155, 160, 771])
def test_k4_k2_bit_equal_to_plain_versions_on_the_crosspol_seams(cuda, n_cr):
    """K4 and K2 against their plain versions and their designed answers on
    the crosspol loop's seam cases: ties within and across float4s, in the
    scalar tail, at the first and last entry, with and without a prior; NaN
    and infinite LUT entries; dsig_cr and s0_cr inside, at the edges of and
    outside the hoisted quotient's windows, denormal divisors included;
    pixels that skip the crosspol beside pixels that run it; padding."""
    cases = crosspol_seam_cases(n_cr)
    feats = cases.feats.copy()
    denormal = np.nonzero(feats[:, 1] == np.float32(2.0 ** -21))[0]
    feats[denormal[::2], 1] = 1e-40  # every second 2**-21 divisor becomes a denormal
    K.reset_launch_counts()
    for f, expected in ((cases.feats, cases.expected), (feats, {})):
        args = (*cases.args(cuda)[:2], torch.as_tensor(f, device=cuda), cases.args(cuda)[3])
        got = K.crosspol_argmin(*args, index=cases.index(cuda))
        ref = K._crosspol_argmin_plain(*args, block=K.CR_BLOCK, index=cases.index(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        assert not _wrong(got.reshape(-1).cpu().numpy(), expected)

    fused, expected = fused_crosspol_seam_cases(n_cr, n_phi=72)
    args2 = fused.k2_args(cuda)
    got2 = K.slab_refine_fused(*args2, index=fused.index(cuda))
    ref2 = K._slab_refine_fused_plain(*args2, has_cr=True, block=K.SLAB_BLOCK,
                                      index=fused.index(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got2, ref2)
    assert not _wrong(got2[2].cpu().numpy(), expected)
    assert K.launch_counts() == {**dict.fromkeys(K.KERNELS, 0), "crosspol_argmin": 2,
                                 "slab_refine_fused": 1}


def _crosspol_luts():
    """The two crosspol tables of ``chip_smoke.py``'s paths, in dB."""
    from pathlib import Path

    from xsarsea_tpu_torch.models import register_pickle_luts

    register_pickle_luts(str(Path(__file__).parent / "data" / "sarwing_luts" / "GMF_fix_cr_2_1"))
    return [np.asarray(get_model(name).to_lut(units="dB").values)
            for name in ("gmf_s1_v2", "sarwing_lut__fix_cr_2_1")]


def test_hoisted_quotient_bit_equal_to_the_true_divide(cuda):
    """The crosspol argmin's quotient (hoisted inside its windows, the true
    divide outside) against ``a / b`` on the card, bit for bit, NaN for NaN:
    2**26 random bit patterns, 2**26 pairs drawn inside the windows, and the
    edge set (significands of all ones and all zeros, the windows' edges,
    zeros, infinities, NaNs, denormals, overflowing and underflowing
    quotients, dsig 0.1, 0.3 and 1.0 under every entry of the two crosspol
    tables minus their neighbours)."""
    sets = {"random bits": quotient_random_set(1 << 26, 0, cuda, windowed=False),
            "inside the windows": quotient_random_set(1 << 26, 1, cuda, windowed=True),
            "edges": quotient_edge_set(cuda, _crosspol_luts())}
    for name, (a, b) in sets.items():
        q, hoisted = E.crosspol_quotient(a, b)
        ref = a / b
        same = (q.view(torch.int32) == ref.view(torch.int32)) | (q.isnan() & ref.isnan())
        bad = torch.nonzero(~same)[:8, 0]
        assert bad.numel() == 0, (name, int((~same).sum()), [
            (hex(x & 0xffffffff), hex(y & 0xffffffff)) for x, y in
            zip(a[bad].view(torch.int32).tolist(), b[bad].view(torch.int32).tolist())])
        share = float(hoisted.float().mean())
        assert share > (0.9 if name == "inside the windows" else 0.01), (name, share)


def test_k5_forms_bit_equal_to_plain_versions(cuda):
    """K5 (slab_forms) in each cost form against its plain version, with
    K3's sentinels (a NaN LUT entry, 1/dsig = inf, padding slots and rows,
    a skipped block); its direct form against K3 itself."""
    rng = np.random.default_rng(5)
    lut, _, _, u, v, _, _ = _operands(rng)
    dev = lambda a: None if a is None else torch.as_tensor(a, device=cuda)  # noqa: E731
    E.reset_launch_counts()
    wp = K.build_direct_arrays(lut, u, v)[0].shape[1]
    nb = 13
    sband = rng.integers(0, 6, nb).astype(np.int32)
    sband[0] = 1
    srow0 = np.clip(rng.integers(0, 9, nb) * 16 - 16, 0, wp - 48).astype(np.int32)
    srow0[0], srow0[1] = 16, wp - 48
    n = nb * 128
    s0 = rng.uniform(-30, -5, n).astype(np.float32)
    ma2, mz2 = (rng.uniform(-6, 6, n).astype(np.float32), rng.uniform(0, 6, n).astype(np.float32))
    feats = {"direct": np.stack([s0, ma2, mz2, np.full(n, 10.0, np.float32)], 1),
             "prescaled": np.stack([s0 * np.float32(10.0), ma2, mz2, np.ones(n, np.float32)], 1)}
    feats["expanded_uv"] = feats["prescaled"]
    for f in feats.values():
        f[3] = np.nan
    feats["direct"][300, 3] = np.inf
    vmask = np.ones(nb, np.int32)
    vmask[7] = 0
    rest = tuple(dev(a) for a in (sband, srow0, vmask))
    for form in E.FORMS:
        args = (form, *(dev(a) for a in E.build_form_arrays(form, lut, u, v, 0.1)),
                dev(feats[form]), *rest)
        got = E.slab_forms(*args)
        ref = E._slab_forms_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), form
        assert (got[0] == 2 ** 30).all() and got.reshape(-1)[3] == 2 ** 30
        if form == "direct":  # K3 reads the slot-order rows through the identity
            k3 = K.slab_refine(*args[1:4], *args[5:], index=identity(args[5]))
            assert torch.equal(got, k3.reshape(got.shape))
            assert got.reshape(-1)[300] == ((2 ** 30 // 181) & ~1) * 181
    assert E.launch_counts() == {f"slab_forms/{form}": 1 for form in E.FORMS}


def test_k6_variants_bit_equal_to_plain_versions(cuda):
    """K6 (group_argmin_variant) in every (block, reduction, precision)
    against its plain version, with a NaN pixel."""
    rng = np.random.default_rng(6)
    g4 = torch.as_tensor(rng.normal(size=(7, 4, 4, 2048)).astype(np.float32), device=cuda)
    E.reset_launch_counts()
    for block in E.VARIANT_BLOCKS:
        feats = rng.normal(size=(3, 4, block)).astype(np.float32)
        feats[1, 2, 5] = np.nan
        args = (g4, torch.as_tensor(feats, device=cuda),
                torch.as_tensor(np.sort(rng.integers(0, 7, 3)), device=cuda))
        for reduction in E.REDUCTIONS:
            for precision in E.PRECISIONS:
                got = E.group_argmin_variant(*args, block=block, reduction=reduction,
                                             precision=precision)
                ref = E._group_argmin_variant_plain(*args, block, reduction, precision)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (block, reduction, precision)
                assert got[1, 0, 5] == 31
    counts = E.launch_counts()
    assert len(counts) == 24 and set(counts.values()) == {1}


def _form_seam_args(cases, form, device):
    """K5's arguments on the slab sweep's seam cases in ``form``: the seam
    LUT and wind grids taken as the form's own operands (its prescaled LUT,
    or -2 u/2, -2 v/2 and kr for expanded_uv), the features (s0, ma/2, mz/2)
    with 1/dsig for the direct form and 1 for the others."""
    lut_pad, u_half, v_half = K.build_direct_arrays(cases.lut, cases.u, cases.v)
    ops = {"direct": (lut_pad, u_half, v_half, None),
           "prescaled": (lut_pad, u_half, v_half, None),
           "expanded_uv": (lut_pad, np.float32(-2) * u_half, np.float32(-2) * v_half,
                           u_half * u_half + v_half * v_half)}[form]
    feats = np.ascontiguousarray(cases.feats[:, :4])
    if form != "direct":
        feats[:, 3] = np.where(np.isnan(feats[:, 0]), np.nan, 1.0)
    dev = lambda a: None if a is None else torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                                           device=device)
    return (form, *(dev(a) for a in ops), dev(feats),
            *(dev(a) for a in (cases.sband, cases.srow0, cases.vmask)))


@pytest.mark.parametrize("n_phi", [37, 181])
@pytest.mark.parametrize("form", E.FORMS)
def test_k5_both_loops_bit_equal_on_the_sweeps_seams(cuda, form, n_phi):
    """K5 on the shared sweep and on the thread loop against its plain
    version on the slab sweep's seam cases (ties across warps, chunks and
    float4s, padding groups, NaN and inf operands); the direct form keeps
    their designed answers."""
    cases = seam_cases(n_phi=n_phi)
    args = _form_seam_args(cases, form, cuda)
    E.reset_launch_counts()
    ref = E._slab_forms_plain(*args)
    for loop in E.LOOPS:
        got = E.slab_forms(*args, loop=loop)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (form, loop, int((got != ref).sum()))
    if form == "direct":
        flat = got.reshape(-1).cpu().numpy()
        assert all(flat[s] == e for s, e in cases.expected.items())
    assert E.launch_counts() == {f"slab_forms/{form}": 1, f"slab_forms_thread/{form}": 1}


@pytest.mark.parametrize("n_rows", [K.SLAB_ROWS, K.EXACT_SLAB_ROWS])
def test_k2_k3_chunk_heights_bit_equal_on_the_sweeps_seams(cuda, n_rows):
    """K2 and K3 at every chunk height equal chunk_rows=8, their plain
    versions and the designed answers on the seam cases; each height counts
    its own launches."""
    cases = seam_cases(n_phi=181, n_rows=n_rows)
    args2, args3 = cases.k2_args(cuda), cases.k3_args(cuda)
    index = cases.index(cuda)
    ref2 = K._slab_refine_fused_plain(*args2, has_cr=True, block=K.SLAB_BLOCK, n_rows=n_rows,
                                      index=index)
    ref3 = K._slab_refine_plain(*args3, block=K.SLAB_BLOCK, n_rows=n_rows, index=index)
    K.reset_launch_counts()
    for rows in K.CHUNK_ROWS:
        got2 = K.slab_refine_fused(*args2, n_rows=n_rows, chunk_rows=rows, index=index)
        got3 = K.slab_refine(*args3, n_rows=n_rows, chunk_rows=rows, index=index)
        torch.cuda.synchronize()
        assert torch.equal(got2, ref2) and torch.equal(got3, ref3), rows
        flat = got3.reshape(-1).cpu().numpy()
        assert all(flat[s] == e for s, e in cases.expected.items()), rows
    counts = K.launch_counts()
    assert counts["slab_refine"] == counts["slab_refine_fused"] == 1
    assert all(counts[f"{k}:chunk_rows={r}"] == 1 for r in (16, 24, 48)
               for k in ("slab_refine", "slab_refine_fused"))
    with pytest.raises(ValueError, match="chunk_rows"):
        K.slab_refine(*args3, n_rows=n_rows, chunk_rows=32, index=index)


def test_chunk_height_over_shared_memory_is_refused_with_its_bytes(cuda):
    """A height whose stages do not fit a block's shared memory is refused
    by the wrapper with the bytes it needs, never run at another height."""
    rng = np.random.default_rng(8)
    lut, _, _, u, v, _, _ = _operands(rng, n_inc=2, n_phi=420)
    args = [torch.as_tensor(a, device=cuda) for a in K.build_direct_arrays(lut, u, v)]
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    feats = torch.as_tensor(np.tile(np.float32([-20, 1, 1, 10]), (128, 1)), device=cuda)
    index = identity(feats)
    base = K.slab_refine(*args, feats, one * 0, one * 16, one, index=index)
    assert torch.equal(K.slab_refine(*args, feats, one * 0, one * 16, one, chunk_rows=16,
                                     index=index), base)
    need = K.slab_smem_bytes(420, K.SLAB_ROWS, 48)
    assert need > 227 * 1024
    with pytest.raises(ValueError, match=f"needs {need} bytes"):
        K.slab_refine(*args, feats, one * 0, one * 16, one, chunk_rows=48, index=index)


def test_k6_tensor_cores_flip_only_near_ties(cuda):
    """K6 on the tensor cores in every (block, reduction, precision): each
    pixel whose group differs from its plain version's is a near-tie, a NaN
    pixel gives 31; its g4 split equals the plain split bit for bit."""
    rng = np.random.default_rng(6)
    g4 = torch.as_tensor(rng.normal(size=(7, 4, 4, 2048)).astype(np.float32), device=cuda)
    E.reset_launch_counts()
    splits = {p: E.split_g4(g4, p) for p in E.PRECISIONS}
    for p, split in splits.items():
        assert torch.equal(split, E._split_g4_plain(g4, p)), p
    for block in E.VARIANT_BLOCKS:
        feats = rng.normal(size=(6, 4, block)).astype(np.float32)
        feats[1, 2, 5] = np.nan
        args = (g4, torch.as_tensor(feats, device=cuda),
                torch.as_tensor(np.sort(rng.integers(0, 7, 6)), device=cuda))
        for reduction in E.REDUCTIONS:
            for precision in E.PRECISIONS:
                kw = dict(block=block, reduction=reduction, precision=precision)
                got = E.group_argmin_variant(*args, **kw, engine="tensor_cores",
                                             g4_split=splits[precision])
                ref = E._group_argmin_variant_plain(*args, block, reduction, precision,
                                                    engine="tensor_cores")
                torch.cuda.synchronize()
                flips = E.tc_flips(*args, got, ref, **kw)
                assert flips["not_near_tie"] == 0, (kw, flips)
                assert flips["differ"] <= 0.01 * got.numel(), (kw, flips)
                assert got[1, 0, 5] == 31
    counts = E.launch_counts()
    assert counts == {"split_g4/highest": 1, "split_g4/default": 1,
                      **{f"group_argmin_variant_tc/{E.variant_name(b, r, p)}": 1
                         for b in E.VARIANT_BLOCKS for r in E.REDUCTIONS for p in E.PRECISIONS}}


def test_unfused_tail_equals_exact_on_card(cuda):
    """A crosspol LUT on its own incidence axis: K1, K3 and K4 on the card
    give the exact path's winds and the CPU run's winners."""
    kw = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    tables = InversionTables(get_model("gmf_cmod5n").to_lut(units="dB", **kw),
                             get_model("gmf_s1_v2").to_lut(units="dB", **{**kw, "inc_step": 0.7}))
    rng = np.random.default_rng(4)
    n = 4000
    inc = rng.uniform(18.0, 47.0, n)
    speed = rng.uniform(0.5, 40.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 * np.log10(get_model("gmf_cmod5n")(inc, speed, phi, broadcast=True).numpy()
                          + 1e-15)
    s0_cr = 10 * np.log10(get_model("gmf_s1_v2")(inc, speed, broadcast=True).numpy() + 1e-15)
    anc = (speed + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    inc[0] = np.nan
    s0_co[1] = np.nan
    args = (inc, s0_co, s0_cr, np.full(n, 0.1), anc)
    K.reset_launch_counts()
    fused = invert_pixels(tables, *args, mode="auto", device=cuda)
    counts = K.launch_counts()
    assert counts["slab_refine_fused"] == 0
    assert min(counts[k] for k in ("group_argmin", "slab_refine", "crosspol_argmin")) >= 1
    exact = invert_pixels(tables, *args, mode="exact", device=cuda)
    cpu = invert_pixels(tables, *args, mode="fused", device="cpu")
    for f, e, c in zip(fused, exact, cpu):
        assert_equal_modulo_pi_ties(f, e)
        np.testing.assert_array_equal(np.isnan(f), np.isnan(c))
        ok = ~np.isnan(c)
        assert (np.abs(f[ok] - c[ok]) <= 2.0 ** -21 * np.abs(c[ok])).all()


def test_fused_equals_exact_on_card(cuda):
    kw = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, **kw)
    rng = np.random.default_rng(1)
    n = 4000
    inc = rng.uniform(18.0, 47.0, n)
    speed = rng.uniform(0.5, 40.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 * np.log10(get_model("gmf_cmod5n")(inc, speed, phi, broadcast=True).numpy()
                          + 1e-15)
    s0_cr = 10 * np.log10(get_model("gmf_s1_v2")(inc, speed, broadcast=True).numpy() + 1e-15)
    anc = (speed + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    inc[0] = np.nan
    args = (inc, s0_co, s0_cr, np.full(n, 0.1), anc)
    K.reset_launch_counts()
    fused = invert_pixels(tables, *args, mode="auto", device=cuda)
    counts = K.launch_counts()
    assert counts["group_argmin"] >= 1 and counts["slab_refine_fused"] >= 1
    exact = invert_pixels(tables, *args, mode="exact", device=cuda)
    cpu = invert_pixels(tables, *args, mode="fused", device="cpu")
    for f, e, c in zip(fused, exact, cpu):
        assert_equal_modulo_pi_ties(f, e)
        # same winners as the CPU run; CUDA's and the CPU's float32 sin/cos
        # of them may differ by an ulp or two
        np.testing.assert_array_equal(np.isnan(f), np.isnan(c))
        ok = ~np.isnan(c)
        assert (np.abs(f[ok] - c[ok]) <= 2.0 ** -21 * np.abs(c[ok])).all()


def test_kernel_wrappers_raise_not_fall_back(cuda):
    feats = torch.zeros((256, 8), device=cuda)[:, :4]  # non-contiguous
    ix = {n: torch.arange(n, device=cuda) for n in (64, 128, 256)}  # identity indices
    with pytest.raises(ValueError, match="contiguous"):
        K.group_argmin(torch.zeros((1, 2, 2), device=cuda), torch.zeros((2, 2), device=cuda),
                       torch.zeros((2, 2), device=cuda),
                       torch.zeros(2, dtype=torch.int32, device=cuda), feats,
                       torch.zeros(1, dtype=torch.int64, device=cuda), 1, index=ix[256])
    rng = np.random.default_rng(2)
    lut, wspd, phir, u, v, crlut, crw = _operands(rng, n_inc=2)
    lut_pad, u_pad, v_pad = (torch.as_tensor(a, device=cuda)
                             for a in K.build_direct_arrays(lut, u, v))
    wp = lut_pad.shape[1]
    ops = (lut_pad, u_pad, v_pad, torch.as_tensor(K.build_decode_arrays(wspd, wp), device=cuda),
           torch.as_tensor(phir, device=cuda),
           *(torch.as_tensor(a, device=cuda) for a in K.build_crosspol_arrays(crlut, crw)),
           torch.zeros((128, 8), device=cuda))
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="sband"):
        K.slab_refine_fused(*ops, one * 2, one * 0, one, index=ix[128])  # band 2 of 2 bands
    with pytest.raises(ValueError, match="srow0"):
        K.slab_refine_fused(*ops, one * 0, one * (wp - K.SLAB_ROWS + 1), one, index=ix[128])
    feats4 = torch.zeros((128, 4), device=cuda)
    with pytest.raises(ValueError, match="sband"):
        K.slab_refine(*ops[:3], feats4, one * 2, one * 0, one, index=ix[128])
    with pytest.raises(ValueError, match="srow0"):
        K.slab_refine(*ops[:3], feats4, one * 0, one * (wp - K.SLAB_ROWS + 1), one,
                      index=ix[128])
    with pytest.raises(ValueError, match="blocks of 128"):  # the sweep's layout is fixed
        K.slab_refine(*ops[:3], torch.zeros((64, 4), device=cuda), one * 0, one * 0, one,
                      block=64, index=ix[64])
    with pytest.raises(ValueError, match="blocks of 128"):
        K.slab_refine_fused(*ops[:7], torch.zeros((64, 8), device=cuda), one * 0, one * 0, one,
                            block=64, index=ix[64])
    with pytest.raises(ValueError, match="band_of_block"):
        K.crosspol_argmin(*ops[5:7], torch.zeros((256, 4), device=cuda), one * 2, index=ix[256])
    with pytest.raises(ValueError, match="blocks of 256"):  # K1's and K4's layouts are fixed
        K.crosspol_argmin(*ops[5:7], torch.zeros((128, 4), device=cuda), one * 0, block=128,
                          index=ix[128])
    coarse = [torch.as_tensor(a, device=cuda) for a in K.build_coarse_arrays(lut, u, v, 4, 4)[:4]]
    with pytest.raises(ValueError, match="blocks of 256"):
        K.group_argmin(*coarse, torch.zeros((128, 4), device=cuda), one * 0, 8, block=128,
                       index=ix[128])
    with pytest.raises(ValueError, match="must not decrease"):
        K.group_argmin(*coarse[:3], coarse[3].flip(0).contiguous(),
                       torch.zeros((256, 4), device=cuda), one * 0, 8, index=ix[256])
    with pytest.raises(ValueError, match="aligned"):
        K.crosspol_argmin(*ops[5:7], torch.zeros(256 * 4 + 1, device=cuda)[1:].reshape(256, 4),
                          one * 0, index=ix[256])


def _prep_scene(ny=96, nx=640, seed=9):
    """Incidence rising along the sample axis, NESZ rising with it (a few
    NaNs), crosspol sigma0 and a copol-like sigma0 with a NaN patch."""
    rng = np.random.default_rng(seed)
    inc = np.linspace(18.0, 47.0, nx)[None, :].repeat(ny, 0) + rng.normal(0, 0.01, (ny, nx))
    nesz = 10.0 ** ((-31.0 + 0.12 * (inc - 30.0) + rng.normal(0, 0.15, inc.shape)) / 10.0)
    nesz[3, 7] = np.nan
    s0_cr = rng.uniform(1e-4, 1e-2, inc.shape)
    s0 = rng.uniform(1e-3, 0.5, inc.shape)
    s0[5:9, 5:9] = np.nan
    return inc, nesz, s0_cr, s0


def test_scene_preparation_on_card_matches_cpu(cuda):
    """``nesz_flattening``, ``get_dsig``, ``get_dsig_wspd`` and
    ``sigma0_detrend`` with ``device="cuda"`` against ``device="cpu"``, float64:
    rtol 1e-9 for the line fit (another summation order), 1e-12 for the
    elementwise ones. numpy in, numpy out; a CUDA tensor in, one out."""
    inc, nesz, s0_cr, s0 = _prep_scene()
    for fn, args, rtol in ((nesz_flattening, (nesz, inc), 1e-9),
                           (get_dsig, ("gmf_s1_v2", inc, s0_cr, nesz), 1e-12),
                           (get_dsig, ("gmf_rs2_v2", inc, s0_cr, nesz), 1e-12),
                           (get_dsig, ("nc_lut_cmodms1ahw", inc, s0_cr, nesz), 1e-12),
                           (get_dsig_wspd, ("dsig_wspd_rs2_v3", s0 * 60.0, inc / 5.0), 1e-12),
                           (sigma0_detrend, (s0, inc), 1e-12)):
        on_card = fn(*args, device="cuda")
        on_cpu = fn(*args, device="cpu")
        assert isinstance(on_card, np.ndarray) and on_card.dtype == np.float64
        np.testing.assert_allclose(on_card, on_cpu, rtol=rtol, atol=0, equal_nan=True)
        dev_args = [torch.as_tensor(a, device=cuda) if isinstance(a, np.ndarray) else a
                    for a in args]
        resident = fn(*dev_args, device="cpu")  # the data's device wins
        assert isinstance(resident, torch.Tensor) and resident.device.type == "cuda"
        np.testing.assert_array_equal(resident.cpu().numpy(), on_card)
    f32 = nesz_flattening(nesz.astype(np.float32), inc.astype(np.float32), device="cuda")
    assert f32.dtype == np.float32
    np.testing.assert_allclose(f32, nesz_flattening(nesz, inc, device="cpu"), rtol=1e-3)


def test_detrend_of_a_chunked_scene_on_card_is_bit_equal_to_eager(cuda):
    import xsarsea_tpu_torch.detrend as D

    class Rows:  # a chunked duck array: first-axis slicing only
        def __init__(self, a):
            self._a, self.shape, self.ndim, self.dtype = a, a.shape, a.ndim, a.dtype
            self.chunks = ((1,) * a.shape[0], (a.shape[1],))
            self.max_request = 0

        def __getitem__(self, idx):
            assert isinstance(idx, slice)
            block = self._a[idx]
            self.max_request = max(self.max_request, block.size)
            return block

    inc, _, _, s0 = _prep_scene()
    eager = sigma0_detrend(s0, inc, device="cuda")
    lazy = Rows(s0)
    old, D._BLOCK_ELEMS = D._BLOCK_ELEMS, 7 * s0.shape[1]
    try:
        got = sigma0_detrend(DimArray(lazy, dims=("line", "sample")), Rows(inc), device="cuda")
    finally:
        D._BLOCK_ELEMS = old
    assert isinstance(got.data, np.ndarray) and lazy.max_request == 7 * s0.shape[1]
    np.testing.assert_array_equal(got.data, eager)


def test_dimarray_on_a_cuda_payload(cuda):
    rng = np.random.default_rng(12)
    data = rng.normal(size=(6, 50, 70))
    data[1, 2, 3] = np.nan
    kw = dict(dims=("a", "b", "c"), coords={"b": np.arange(50.0), "c": np.arange(70.0)})
    host = DimArray(data, **kw)
    dev = host.to(cuda)
    assert dev.data.device.type == "cuda" and isinstance(dev.numpy().data, np.ndarray)
    for name in ("mean", "nanmean", "sum", "min", "max"):
        for dim in ("b", ("a", "c")):
            got, ref = getattr(dev, name)(dim), getattr(host, name)(dim)
            assert got.data.device.type == "cuda" and got.dims == ref.dims
            np.testing.assert_allclose(got.values, ref.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(dev.coarsen_mean({"b": 4, "c": 3}).values,
                               host.coarsen_mean({"b": 4, "c": 3}).values, rtol=1e-12)
    # (a tensor over a Python scalar is a multiply by its reciprocal on CUDA,
    # an ulp off numpy's divide: the bit-equal cases divide by no scalar)
    ops = [lambda x: (x * 2.0 - x.isel(a=0)) * 0.5, lambda x: x / (x + 3.0),
           lambda x: x.where(x > 0.0, -1.0),
           lambda x: x.fillna(0.0).pad({"b": 2}, mode="reflect"),
           lambda x: x.sel(b=[3.0, 7.0]).transpose("c", "b", "a"),
           lambda x: x.interp(c=np.linspace(0.0, 69.0, 33)), lambda x: (x + 360.0) % 360.0]
    for op in ops:
        got, ref = op(dev), op(host)
        assert got.data.device.type == "cuda" and got.dims == ref.dims
        np.testing.assert_array_equal(got.values, ref.values)
    mixed = dev + host.isel(a=0)  # a numpy operand follows the tensor to its device
    assert mixed.data.device.type == "cuda"


def test_invert_from_model_dataarrays_on_card(cuda):
    """DataArray-like inputs, a per-pixel ``dsig_cr`` array among them,
    through ``xarray_io`` into the fused kernels; the caller's class back."""
    from _xr_stub import DataArray

    rng = np.random.default_rng(13)
    ny, nx = 64, 256
    inc = np.linspace(19.0, 45.0, nx)[None, :].repeat(ny, 0)
    speed = rng.uniform(2.0, 24.0, (ny, nx))
    direc = rng.uniform(-np.pi, np.pi, (ny, nx))
    s0_co = get_model("gmf_cmod5n")(inc, speed, np.abs(np.rad2deg(direc))).numpy()
    s0_cr = get_model("gmf_s1_v2")(inc, speed, broadcast=True).numpy()
    nesz = np.full_like(s0_cr, 10 ** -3.2)
    da = lambda a: DataArray(a, dims=("line", "sample"))  # noqa: E731
    dsig = get_dsig("gmf_s1_v2", da(inc), da(s0_cr), da(nesz))
    assert isinstance(dsig, DataArray)
    kw = dict(ancillary_wind=da(speed * np.exp(1j * direc)), dsig_cr=dsig,
              model=("gmf_cmod5n", "gmf_s1_v2"), inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    K.reset_launch_counts()
    co, dual = invert_from_model(da(inc), da(s0_co), da(s0_cr), **kw)  # device="cuda"
    counts = K.launch_counts()
    assert counts["group_argmin"] >= 1 and counts["slab_refine_fused"] >= 1
    exact = invert_from_model(da(inc), da(s0_co), da(s0_cr), mode="exact", **kw)
    for got, ref in zip((co, dual), exact):
        assert isinstance(got, DataArray) and got.dims == ("line", "sample")
        assert "model" in got.attrs and "comment" in got.attrs
        differ = ~(got.values == ref.values)
        assert differ.mean() < 0.005, differ.sum()  # near-tie flips only (1/dsig vs divide)
    assert np.sqrt(np.mean((np.abs(dual.values) - speed) ** 2)) < 0.5


def _stream_scene(n, seed):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    speed = rng.uniform(0.5, 30.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    dev = [torch.as_tensor(a, device="cuda") for a in (inc, speed, np.abs(np.rad2deg(direc)))]
    s0_co = get_model("gmf_cmod5n")(*dev, broadcast=True).cpu().numpy()
    s0_cr = get_model("gmf_s1_v2")(dev[0], dev[1], broadcast=True).cpu().numpy()
    anc = (speed + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * direc)
    inc[0], s0_co[1], anc[2], s0_cr[3] = np.nan, np.nan, np.nan, np.nan
    return inc, s0_co, s0_cr, anc


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mode,dtype", [("fused", torch.float32), ("exact", torch.float64)])
def test_overlapped_piece_loop_equals_serial_on_card(cuda, mode, dtype):
    """The three lanes on their streams (copies in, kernels, copies out through
    pinned buffers) against the serial loop: bit for bit, for host arrays in
    and out, for results kept on the card, and for tensors already there."""
    from xsarsea_tpu_torch.utils import staging
    from xsarsea_tpu_torch.windspeed.inversion import _invert_source, _LazySource

    n, piece = (1 << 20) + 12345, 1 << 18  # five pieces, the last ragged
    if mode == "exact":
        n, piece = 9000, 2048
    inc, s0_co, s0_cr, anc = _stream_scene(n, 21)
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=dtype, inc_step=0.5,
                            wspd_step=0.2, phi_step=2.5)

    def run(**kw):
        src = _LazySource((n,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc)
        return _invert_source(tables, src, mode=mode, device=cuda, piece_size=piece, **kw)

    pinned_before = staging.pool().bytes
    serial = run(_overlap=False)
    for _ in range(3):  # the lanes' timing differs run to run: the bits must not
        for got, ref in zip(run(), serial):
            assert _same_bits(got, ref)
    torch.cuda.synchronize()
    # every buffer is back in the pool, which holds a few pieces' worth, not the scene's
    pool = staging.pool()
    assert not pool._pending or all(ev.query() for ev, _ in pool._pending)
    assert pool.bytes - pinned_before <= 40 * piece * 8
    on_card = run(device_output=True)
    assert all(t.device.type == "cuda" and t.is_complex() for t in on_card)
    for got, ref in zip(on_card, serial):
        assert _same_bits(got.cpu().numpy(), ref)
    # tensors in: pieces are views (a side stream must wait for their making)
    f = dict(dtype=dtype, device=cuda)
    db = lambda x: 10.0 * torch.log10(torch.as_tensor(x, **f) + 1e-15)  # noqa: E731
    args = (torch.as_tensor(inc, **f), db(s0_co), db(s0_cr), torch.full((n,), 0.1, **f),
            torch.as_tensor(anc, device=cuda).to(torch.complex64 if dtype == torch.float32
                                                else torch.complex128))
    ref = invert_pixels(tables, *args, mode=mode, device=cuda, piece_size=n)
    got = invert_pixels(tables, *args, mode=mode, device=cuda, piece_size=piece)
    for g, r in zip(got, ref):
        assert _same_bits(g, r)


def test_staging_round_trip_on_card(cuda):
    """``to_device`` and ``to_host`` through pinned buffers: the values a plain
    copy gives, for casts, strided sources, chunked results and ``out=``."""
    from xsarsea_tpu_torch.utils import staging

    rng = np.random.default_rng(22)
    a = rng.normal(size=(3000, 4100))  # 98 MB as float64: several 32 MiB chunks back
    t = staging.to_device(a, cuda, torch.float32)
    assert t.device.type == "cuda" and t.dtype == torch.float32
    assert torch.equal(t.cpu(), torch.as_tensor(a.astype(np.float32)))
    t64 = staging.to_device(a[::2, ::3], cuda)
    back = staging.to_host(t64)
    assert back.dtype == np.float64 and np.array_equal(back, a[::2, ::3])
    whole = staging.to_host(staging.to_device(a, cuda))
    assert np.array_equal(whole, a)
    out = np.zeros((2,) + a.shape)
    assert staging.to_host(t, out=out[1]) is not None
    assert np.array_equal(out[1], a.astype(np.float32)) and not out[0].any()
    z = torch.as_tensor(a[:100] + 1j * a[100:200], device=cuda)
    assert np.array_equal(staging.to_host(z), a[:100] + 1j * a[100:200])
    small = staging.to_device(np.arange(10), cuda)  # too small for a staging buffer
    assert small.device.type == "cuda" and small.tolist() == list(range(10))
    assert DimArray(t64, dims=("line", "sample")).values.shape == t64.shape
    assert staging.pool().bytes > 0


def test_streaks_card_against_cpu(cuda):
    """The wind-streak path on the card against ``device="cpu"`` in float64:
    local gradients to 1e-11 of the largest value (stencils added in a fixed
    order), histograms to rtol 1e-9 with atol 1e-12 (the card's ``index_add_``
    sums in any order), through the core, the banded out-of-core routine and
    the multiscale class."""
    from xsarsea_tpu_torch import gradients as G

    rng = np.random.default_rng(23)
    ny, nx = 600, 520
    yy, xx = np.mgrid[0:ny, 0:nx]
    img = (1.0 + 0.4 * np.sin(0.3 * (xx + 0.7 * yy)) + 0.1 * rng.normal(size=(ny, nx))) ** 2
    bins = G._angle_bin_centers(72)
    lg = {d: G.local_gradients(G.Gradients2D(img, device=d).ampl) for d in ("cuda", "cpu")}
    for name in ("G2", "G2_abs", "G2_angle", "G3", "c"):
        got, ref = lg["cuda"][name].values, lg["cpu"][name].values
        assert lg["cuda"][name].data.device.type == "cuda"
        assert np.abs(got - ref).max() <= 1e-11 * np.abs(ref).max(), name
    cl = np.r_[0, np.arange(10, ny // 4, 16), ny // 4 - 1]
    cs = np.r_[0, np.arange(10, nx // 4, 16), nx // 4 - 1]
    tol = dict(rtol=1e-9, atol=1e-12)
    ref_h, ref_r = (t.numpy() for t in G.streaks_histogram_core(img, cl, cs, 16, bins,
                                                               device="cpu"))
    got_h, got_r = G.streaks_histogram_core(img, cl, cs, 16, bins)  # device="cuda"
    assert got_h.device.type == "cuda"
    np.testing.assert_allclose(got_h.cpu().numpy(), ref_h, **tol)
    np.testing.assert_array_equal(got_r.cpu().numpy(), ref_r)

    class Rows:  # a chunked duck array over the image
        shape, ndim, dtype, chunks = img.shape, 2, img.dtype, ((1,) * ny, (nx,))
        max_request = 0

        def __getitem__(self, idx):
            block = img[idx]
            Rows.max_request = max(Rows.max_request, block.size)
            return block

    band_h, band_r = G._banded_streaks_hist(Rows(), cl, cs, 16, bins, max_block_px=200 * nx)
    np.testing.assert_allclose(band_h.cpu().numpy(), ref_h, **tol)
    np.testing.assert_array_equal(band_r.cpu().numpy(), ref_r)
    assert 0 < Rows.max_request < img.size
    da = DimArray(np.stack([img, 0.3 * img]), dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV", "VH"]), "line": np.arange(ny) * 10.0,
                          "sample": np.arange(nx) * 10.0})
    kw = dict(windows_sizes=[800, 1600], downscales_factors=[1, 2])
    got, ref = G.Gradients(da, **kw).histogram, G.Gradients(da, device="cpu", **kw).histogram
    assert got["weight"].data.device.type == "cuda" and got["weight"].dims == ref["weight"].dims
    np.testing.assert_allclose(got["weight"].values, ref["weight"].values, **tol)
    np.testing.assert_array_equal(got["used_ratio"].values, ref["used_ratio"].values)
    f1 = G.filtering_parameters(img)[4].values
    np.testing.assert_allclose(f1, G.filtering_parameters(img, device="cpu")[4].values,
                               rtol=1e-9, atol=1e-12)


# ------------------------------------------- fused_exact: K1 streamed, 32-row slabs

def _full_grid_operands(rng, n_inc=3, n_rows=499, n_cols=181, n_blocks=12):
    """K1 operands on a full-size grid (rows grouped by 16), with NaN entries,
    a NaN row, exact ties across the streamed form's 16-row chunks and its
    row chains, and padding; ``expected``: slot -> designed group."""
    lut = rng.uniform(-35, 0, (n_inc, n_rows, n_cols)).astype(np.float32)
    u = rng.uniform(-12, 12, (n_rows, n_cols)).astype(np.float32)
    v = rng.uniform(0, 12, (n_rows, n_cols)).astype(np.float32)
    lut[1, 100, 7] = np.nan
    lut[2, 200] = np.nan
    row_group = (np.arange(n_rows) // K.WGROUP).astype(np.int32)
    n = n_blocks * K.GROUP_BLOCK
    feats = np.stack([rng.uniform(-35, 0, n), rng.uniform(-12, 12, n) * 0.5,
                      rng.uniform(0, 12, n) * 0.5, np.full(n, 10.0)], 1).astype(np.float32)
    band = rng.integers(0, n_inc, n_blocks)
    band[0] = 0
    expected = {}
    # (row, col) pairs holding one value: across chunks (15/16), chains (rows
    # mod 4), far apart, the grid's last row and first entry
    ties = [[(15, 3), (16, 3)], [(47, 180), (33, 2)], [(498, 100), (250, 100)],
            [(0, 0), (480, 50)], [(17, 8), (18, 8), (19, 9)]]
    for k, cells in enumerate(ties):
        (r1, c1), rest = cells[0], cells[1:]
        for r, c in rest:
            lut[0, r, c], u[r, c], v[r, c] = lut[0, r1, c1], u[r1, c1], v[r1, c1]
        for rep in range(4):  # in four 32-pixel groups of block 0
            s = 32 * (2 * rep) + 5 * k + rep
            r, c = cells[rep % len(cells)]
            feats[s] = lut[0, r, c], u[r, c] * 0.5, v[r, c] * 0.5, 10.0
            expected[s] = min(r // K.WGROUP for r, _ in cells)
    feats[K.GROUP_BLOCK + 40:2 * K.GROUP_BLOCK] = np.nan  # padding, mid-group
    feats[5 * K.GROUP_BLOCK:6 * K.GROUP_BLOCK] = np.nan  # a padding-only block
    feats[7 * K.GROUP_BLOCK + 3, 3] = np.inf  # no finite cost: the last group
    expected[7 * K.GROUP_BLOCK + 3] = row_group[-1]
    return (lut, u * 0.5, v * 0.5, row_group, feats, band.astype(np.int64),
            int(row_group[-1]) + 1), expected


def _streamed_both_ways(args, radii, n_blocks):
    """K1's streamed form with pruning and without, and each one's chunks
    and rows staged per block."""
    swept = [torch.zeros((n_blocks, 3), dtype=torch.int32, device=args[0].device)
             for _ in range(2)]
    index = identity(args[4])  # rows in slot order
    got = [K.group_argmin_streamed(*args, index=index, radii=radii, swept=s, _prune=p)
           for s, p in zip(swept, (True, False))]
    return got, swept


@pytest.mark.parametrize("n_cols", [19, 46, 181])
def test_k1_streamed_bit_equal_to_plain_version(cuda, n_cols):
    """K1's streamed form, with pruning and without, against its plain
    version and the designed answers: on the coarse seam cases at the width
    given (2-3 rows a group, groups across its chunks), and the staged form
    there too; on those cases lifted to a full grid (a group a chunk); and
    on a full-size 499 x 181 grid with ties across the stream's chunks and
    chains, NaN entries and padding."""
    K.reset_launch_counts()
    for cases, staged in ((coarse_seam_cases(n_cols), True), (full_grid_seam_cases(n_cols), False)):
        args = cases.args(cuda)
        (got, got_all), swept = _streamed_both_ways(args, cases.radii(cuda),
                                                    cases.band_of_block.shape[0])
        ref = K._group_argmin_plain(*args, block=K.GROUP_BLOCK, chunk_blocks=2,
                                    index=cases.index(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(got_all, ref)
        if staged:
            assert torch.equal(K.group_argmin(*args, index=cases.index(cuda)), ref)
        assert not _wrong(got.reshape(-1).cpu().numpy(), cases.expected)
        assert (swept[0][:, 0] <= swept[1][:, 0]).all()
    if n_cols == 181:
        ops, expected = _full_grid_operands(np.random.default_rng(31))
        assert not K.k1_staged_fits(*ops[1].shape)
        args = (*(torch.as_tensor(a, device=cuda) for a in ops[:6]), ops[6])
        radii = torch.as_tensor(K.build_chunk_radii(ops[1], ops[2]), device=cuda)
        (got, got_all), _ = _streamed_both_ways(args, radii, ops[5].shape[0])
        ref = K._group_argmin_plain(*args, block=K.GROUP_BLOCK, chunk_blocks=2,
                                    index=identity(args[4]))
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(got_all, ref)
        assert not _wrong(got.reshape(-1).cpu().numpy(), expected)
        with pytest.raises(ValueError, match="does not fit"):
            K.group_argmin(*args, index=identity(args[4]))
    counts = K.launch_counts()
    assert counts["group_argmin"] == 1 and counts["group_argmin_streamed"] == 4 + 2 * (n_cols == 181)


@pytest.mark.parametrize("case", ["prune-37", "prune-181", "seams-46"])
def test_k1_streamed_prune_schedule_on_card(cuda, case):
    """The pruned streamed K1 on the prune seams (ties between a home group
    and a later or earlier one, a best equal to a bound, an all-NaN group,
    sorted and unsorted random blocks, extreme priors and dsig) and on K1's
    coarse seams (groups not one a chunk): bit-equal to its plain version
    and to itself unpruned, at the designed answers, and staging per block
    exactly the chunks and rows of the plain model of its schedule."""
    kind, n_cols = case.split("-")
    cases = (prune_seam_cases if kind == "prune" else coarse_seam_cases)(int(n_cols))
    args = cases.args(cuda)
    (got, got_all), swept = _streamed_both_ways(args, cases.radii(cuda),
                                                cases.band_of_block.shape[0])
    cpu_args = cases.args("cpu")
    ref = K._group_argmin_plain(*cpu_args, block=K.GROUP_BLOCK, index=cases.index("cpu"))
    model, model_swept = K._group_argmin_pruned_model(*cpu_args, cases.radii("cpu"))
    _, model_all = K._group_argmin_pruned_model(*cpu_args, cases.radii("cpu"), prune=False)
    assert torch.equal(got.cpu(), ref) and torch.equal(got_all.cpu(), ref)
    assert torch.equal(model, ref)
    assert not _wrong(got.reshape(-1).cpu().numpy(), cases.expected)
    assert torch.equal(swept[0].cpu(), model_swept) and torch.equal(swept[1].cpu(), model_all)
    if kind == "prune":
        assert int(model_swept[:, 0].sum()) < int(model_all[:, 0].sum())


def test_k1_lower_bounds_on_card_equal_their_emulation(cuda):
    """The streamed K1's bound from the kernel's device function against its
    float64 emulation, bit for bit (NaN for NaN), on priors at every annulus
    edge of the high-resolution grid and one float either side, at 0, 1e-30,
    1e30, denormal, NaN and infinite."""
    tables = prepare_tables("gmf_cmod5n", dtype=torch.float32)
    _, u_c, v_c, _, _ = K.build_coarse_arrays(np.asarray(tables.co_lut), np.asarray(tables.co_u),
                                              np.asarray(tables.co_v), 1, 1)
    radii = K.build_chunk_radii(u_c, v_c)
    edges = radii.reshape(-1)
    rho = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                          np.nextafter(edges, np.float32(np.inf)),
                          np.float32([0, 1e-30, 1e30, 1e-40, 3e-45, np.inf, np.nan])])
    ang = np.random.default_rng(2).uniform(0, np.pi, rho.size)
    feats = np.stack([np.zeros_like(rho), rho * np.cos(ang), rho * np.sin(ang),
                      np.ones_like(rho)], 1).astype(np.float32)
    feats = np.concatenate([feats, np.stack([np.zeros_like(rho), rho, np.zeros_like(rho),
                                             np.ones_like(rho)], 1).astype(np.float32)])
    got = K.chunk_lower_bounds(torch.as_tensor(feats, device=cuda),
                               torch.as_tensor(radii, device=cuda)).cpu()
    ref = K.chunk_lower_bounds(torch.as_tensor(feats), torch.as_tensor(radii))
    same = (got.view(torch.int32) == ref.view(torch.int32)) | (got.isnan() & ref.isnan())
    assert bool(same.all()), int((~same).sum())


@pytest.mark.parametrize("n_phi", [37, 72, 181])
def test_k2_k3_at_32_rows_bit_equal_on_the_sweeps_seams(cuda, n_phi):
    """K2 and K3 on 32-row slabs (the fused_exact mode's) against their plain
    versions and the designed answers, on the seam cases built for 32 rows;
    the slab start is checked against the slab's height."""
    cases = seam_cases(n_phi=n_phi, n_rows=K.EXACT_SLAB_ROWS)
    args2, args3 = cases.k2_args(cuda), cases.k3_args(cuda)
    index = cases.index(cuda)
    got2 = K.slab_refine_fused(*args2, n_rows=32, index=index)
    got3 = K.slab_refine(*args3, n_rows=32, index=index)
    ref2 = K._slab_refine_fused_plain(*args2, has_cr=True, block=K.SLAB_BLOCK, n_rows=32,
                                      index=index)
    ref3 = K._slab_refine_plain(*args3, block=K.SLAB_BLOCK, n_rows=32, index=index)
    torch.cuda.synchronize()
    assert torch.equal(got2, ref2) and torch.equal(got3, ref3)
    flat = got3.reshape(-1).cpu().numpy()
    assert all(flat[s] == e for s, e in cases.expected.items())
    wp = args3[0].shape[1]
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    feats4 = torch.zeros((128, 4), device=cuda)
    ix = identity(feats4)
    K.slab_refine(*args3[:3], feats4, one * 0, one * (wp - 32), one, n_rows=32, index=ix)
    with pytest.raises(ValueError, match="srow0"):
        K.slab_refine(*args3[:3], feats4, one * 0, one * (wp - 31), one, n_rows=32, index=ix)
    with pytest.raises(ValueError, match="n_rows"):
        K.slab_refine(*args3[:3], feats4, one * 0, one * 0, one, n_rows=wp + 8, index=ix)


def _gmf_pixels(n, seed):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    speed = rng.uniform(0.5, 40.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 * np.log10(get_model("gmf_cmod5n")(inc, speed, phi, broadcast=True).numpy()
                          + 1e-15)
    s0_cr = 10 * np.log10(get_model("gmf_s1_v2")(inc, speed, broadcast=True).numpy() + 1e-15)
    anc = (speed + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(1j * np.deg2rad(phi))
    inc[0] = np.nan
    s0_co[1] = np.nan
    return inc, s0_co, s0_cr, np.full(n, 0.1), anc


@pytest.mark.parametrize("cross_axis", ["shared", "own"])
def test_fused_exact_equals_exact_on_card(cuda, cross_axis):
    """``fused_exact`` on the card: K1 on the full grid (streamed at the
    high-res grid, staged where the grid fits), K2 or K3 + K4 on 32-row
    slabs; the exact path's winds up to the phi tie, the fused mode's, and
    the CPU run's winners."""
    kw = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    cr_kw = kw if cross_axis == "shared" else {**kw, "inc_step": 0.7}
    tables = InversionTables(get_model("gmf_cmod5n").to_lut(units="dB", **kw),
                             get_model("gmf_s1_v2").to_lut(units="dB", **cr_kw))
    args = _gmf_pixels(4000, 5)
    K.reset_launch_counts()
    got = invert_pixels(tables, *args, mode="fused_exact", device=cuda)
    counts = K.launch_counts()
    tail = ("slab_refine_fused",) if cross_axis == "shared" else ("slab_refine",
                                                                  "crosspol_argmin")
    assert counts["group_argmin_streamed"] >= 1 and min(counts[k] for k in tail) >= 1
    exact = invert_pixels(tables, *args, mode="exact", device=cuda)
    fused = invert_pixels(tables, *args, mode="fused", device=cuda)
    cpu = invert_pixels(tables, *args, mode="fused_exact", device="cpu")
    for g, e, f, c in zip(got, exact, fused, cpu):
        assert_equal_modulo_pi_ties(g, e)
        assert _same_bits(g, f)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(c))
        ok = ~np.isnan(c)
        assert (np.abs(g[ok] - c[ok]) <= 2.0 ** -21 * np.abs(c[ok])).all()
    hr = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32)  # 499 x 181
    K.reset_launch_counts()
    hr_got = invert_pixels(hr, *args, mode="fused_exact", device=cuda)
    assert K.launch_counts()["group_argmin_streamed"] >= 1
    for g, e in zip(hr_got, invert_pixels(hr, *args, mode="exact", device=cuda)):
        assert_equal_modulo_pi_ties(g, e)


def test_sharded_invert_pixels_on_one_card_twice(cuda):
    """A mesh naming the card twice: the sharded fused and exact paths give
    the one-device results bit for bit, and the line-sharded streaks the
    one-device core's."""
    from xsarsea_tpu_torch import gradients as G
    from xsarsea_tpu_torch import parallel as par

    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, inc_step=0.5,
                            wspd_step=0.2, phi_step=2.5)
    args = _gmf_pixels(5000, 6)
    twice = ["cuda:0", "cuda:0"]
    for mode, shape in (("fused", (2, 1)), ("fused_exact", (2, 1)), ("exact", (1, 2)),
                        ("exact", (2, 1))):
        got = par.sharded_invert_pixels(tables, *args, mesh=par.make_mesh(*shape, devices=twice),
                                        mode=mode)
        ref = invert_pixels(tables, *args, mode=mode, device=cuda)
        for g, r in zip(got, ref):
            assert _same_bits(g, r), (mode, shape)
    rng = np.random.default_rng(7)
    img = np.abs(1.0 + 0.1 * rng.normal(size=(1024, 768))) + 0.01
    cl, cs = np.arange(8, 248, 10), np.arange(8, 184, 10)
    bins = G._angle_bin_centers(72)
    w, r = par.sharded_streaks_histogram(img, cl, cs, 16, bins,
                                         par.make_mesh(2, 1, devices=twice))
    ref_w, ref_r = (t.cpu().numpy() for t in G.streaks_histogram_core(img, cl, cs, 16, bins))
    np.testing.assert_allclose(w.reshape(ref_w.shape), ref_w, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(r.reshape(ref_r.shape), ref_r)


def test_cli_invert_on_card_launches_k1_k2_and_equals_invert_from_model(cuda, tmp_path, capsys):
    """``xsarsea-tpu-torch invert`` with its defaults (the card, mode auto ->
    fused) on a 2**18-px scene directory: K1 and K2 launched, winds bit-equal
    to ``invert_from_model`` on the same memmaps."""
    from xsarsea_tpu_torch import cli

    ny = nx = 512
    inc, s0_co_db, s0_cr_db, _, anc = _gmf_pixels(ny * nx, 9)
    d = tmp_path / "scene"
    d.mkdir()
    for key, arr in (("inc", inc), ("sigma0", 10 ** (s0_co_db / 10)),
                     ("sigma0_dual", 10 ** (s0_cr_db / 10)), ("ancillary_wind", anc)):
        np.save(d / f"{key}.npy", arr.reshape(ny, nx))
    K.reset_launch_counts()
    cli.main(["invert", str(d), str(tmp_path / "wind.npz"), "--model", "gmf_cmod5n,gmf_s1_v2"])
    launches = K.launch_counts()
    assert launches["group_argmin"] and launches["slab_refine_fused"], launches
    assert "inverted 262144 px" in capsys.readouterr().out
    got = np.load(tmp_path / "wind.npz")
    mm = {f[:-4]: np.load(d / f, mmap_mode="r") for f in ("inc.npy", "sigma0.npy",
                                                          "sigma0_dual.npy",
                                                          "ancillary_wind.npy")}
    ref = invert_from_model(mm["inc"], mm["sigma0"], mm["sigma0_dual"],
                            ancillary_wind=mm["ancillary_wind"], dsig_cr=0.1,
                            model=("gmf_cmod5n", "gmf_s1_v2"))
    assert _same_bits(got["wind_co"], ref[0]) and _same_bits(got["wind_dual"], ref[1])


def test_trace_names_k1_and_k2(cuda, tmp_path):
    """``utils.trace`` around a device-resident fused call writes a trace
    whose device events name K1's and K2's kernels."""
    import json

    from xsarsea_tpu_torch.utils import trace

    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, inc_step=0.5,
                            wspd_step=0.2, phi_step=2.5)
    dev = [torch.as_tensor(np.asarray(a, np.float32), device=cuda)
           for a in _gmf_pixels(1 << 16, 10)[:4]]
    anc = torch.as_tensor(_gmf_pixels(1 << 16, 10)[4].astype(np.complex64), device=cuda)
    invert_pixels(tables, *dev, anc, device=cuda, device_output=True)  # build and warm up
    with trace(tmp_path / "trace") as tr:
        invert_pixels(tables, *dev, anc, device=cuda, device_output=True)
    with open(tr.path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("group_argmin" in n for n in names), sorted(names)[:50]
    assert any("slab_refine_fused" in n for n in names)


def test_plot_gradients_peak_on_card_against_cpu(cuda):
    """``PlotGradients(hist).peak`` on the card against the CPU in float64:
    angles equal where a window's two largest weights differ by more than
    1e-9 relative (the card's histogram sums in any order), weights to rtol
    1e-9."""
    from xsarsea_tpu_torch import gradients as G

    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:512, 0:512]
    img = (1.0 + 0.4 * np.sin(0.3 * (xx + 0.7 * yy)) + 0.1 * rng.normal(size=(512, 512))) ** 2
    da = DimArray(np.stack([img, 0.3 * img]), dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV", "VH"]), "line": np.arange(512) * 10.0,
                          "sample": np.arange(512) * 10.0})
    kw = dict(windows_sizes=[800, 1600], downscales_factors=[1, 2])
    peaks = {d: G.PlotGradients(G.Gradients(da, device=d, **kw).histogram).peak
             for d in ("cuda", "cpu")}
    assert peaks["cuda"]["angle"].data.device.type == "cuda"
    ref_w = G.Gradients(da, device="cpu", **kw).histogram["weight"].values
    top2 = np.sort(ref_w, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-9 * np.abs(top2[..., 1])
    got_a, ref_a = peaks["cuda"]["angle"].values, peaks["cpu"]["angle"].values
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_a[clear], ref_a[clear])
    np.testing.assert_allclose(peaks["cuda"]["weight"].values, peaks["cpu"]["weight"].values,
                               rtol=1e-9)


def test_gmf_grid_of_card_tensors(cuda):
    """All-1-D CUDA inputs give the outer-product grid on the card with host
    coordinates, equal to the CPU's in float64 (the GMF's arithmetic in a
    fixed order: rtol 1e-12)."""
    grids = [np.linspace(20.0, 45.0, 6), np.linspace(1.0, 30.0, 7), np.linspace(0.0, 180.0, 5)]
    got = get_model("gmf_cmod5n")(*(torch.as_tensor(g, device=cuda) for g in grids))
    ref = get_model("gmf_cmod5n")(*grids)
    assert got.data.device.type == "cuda" and got.dims == ("incidence", "wspd", "phi")
    for d, g in zip(got.dims, grids):
        assert isinstance(got.coords[d], np.ndarray)
        np.testing.assert_array_equal(got.coords[d], g)
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-12)


def _merge_bits(w):
    return torch.view_as_real(w).view(torch.int32).cpu()


def test_dual_merge_bit_equal_to_plain_version(cuda):
    """``dual_merge`` against its plain version (on the CPU) on 2**22 random
    px with NaN in either part, the seams of ``test_torch_dual_merge`` in
    either wind at the front: 16-byte aligned planes (the float4 loop and a
    ragged tail) and planes one float off (one pixel a thread)."""
    from test_torch_dual_merge import _seams

    rng = np.random.default_rng(31)
    n = (1 << 22) + 3
    planes = rng.normal(0, 6, (4, n + 1)).astype(np.float32)
    for row in planes:
        row[rng.integers(0, n, 3000)] = np.nan
    seam = _seams()
    k = seam.shape[0]
    planes[0, :k], planes[1, :k] = seam.real, seam.imag
    planes[2, k:2 * k], planes[3, k:2 * k] = seam.real, seam.imag
    dev = torch.as_tensor(planes, device=cuda)
    K.reset_launch_counts()
    for lo in (0, 1):
        args = [p[lo:lo + n] for p in dev]
        assert (args[0].data_ptr() % 16 == 0) == (lo == 0)
        got = K.dual_merge(*args)
        ref = K._dual_merge_plain(*(a.cpu() for a in args))
        for g, r in zip(got, ref):
            assert g.dtype == torch.complex64 and g.device.type == "cuda"
            assert torch.equal(_merge_bits(g), _merge_bits(r))
    assert K.launch_counts()["dual_merge"] == 2


def test_invert_from_model_merges_on_card(cuda):
    """Dual-pol ``invert_from_model`` on the card in three pieces: one
    ``dual_merge`` launch a piece, every pixel counted as merged on the card,
    the numpy merge's winds bit for bit except where a speed lies within one
    float32 ulp of 5 m/s, and the overlapped lanes the serial loop's bits.
    Mono-pol calls, ``invert_pixels`` and float64 tables launch no merge."""
    from xsarsea_tpu_torch.utils import spans
    from xsarsea_tpu_torch.windspeed.inversion import _invert_source, _LazySource

    steps = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    piece = 1 << 18
    n = 3 * piece - 77
    inc, s0_co, s0_cr, anc = _stream_scene(n, 23)
    before = spans.counters()
    K.reset_launch_counts()
    co, dual = invert_from_model(inc, s0_co, s0_cr, ancillary_wind=anc,
                                 model=("gmf_cmod5n", "gmf_s1_v2"), piece_size=piece, **steps)
    after = spans.counters()
    assert K.launch_counts()["dual_merge"] == 3
    assert after["merge_px_card"] - before["merge_px_card"] == n
    assert after["merge_px_host"] == before["merge_px_host"]

    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, **steps)

    def run(**kw):
        src = _LazySource((n,), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc)
        return _invert_source(tables, src, device=cuda, piece_size=piece, **kw)

    raw_co, raw_du = run()
    assert _same_bits(co, raw_co)
    take = (np.abs(raw_co) < 5) | (np.abs(raw_du) < 5)
    host = np.where(take, raw_co, raw_du)
    ulp = np.spacing(np.float32(5))
    near = np.zeros(n, bool)
    for w in (raw_co, raw_du):
        with np.errstate(invalid="ignore"):
            near |= np.abs(np.abs(w.astype(np.complex128)) - 5) <= ulp
    differ = dual.view(np.uint64) != host.view(np.uint64)
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    # near: mostly speeds on the LUT's 5 m/s row (every 25th of its 0.2-m/s
    # rows), whose float32 modulus falls either side of 5 with the direction
    assert near.mean() < 0.02, (int(near.sum()), int(differ.sum()))

    serial = run(merge=True, _overlap=False)
    assert _same_bits(serial[0], co) and _same_bits(serial[1], dual)
    for _ in range(2):  # the lanes' timing differs run to run: the bits must not
        for got, ref in zip(run(merge=True), serial):
            assert _same_bits(got, ref)

    K.reset_launch_counts()
    invert_from_model(inc, s0_co, ancillary_wind=anc, model="gmf_cmod5n", **steps)
    db = lambda x: 10 * np.log10(x + 1e-15)  # noqa: E731
    invert_pixels(tables, inc, db(s0_co), db(s0_cr), np.full(n, 0.1), anc, device=cuda)
    assert K.launch_counts().get("dual_merge", 0) == 0
    m = 2048
    before = spans.counters()
    invert_from_model(inc[:m], s0_co[:m], s0_cr[:m], ancillary_wind=anc[:m],
                      model=("gmf_cmod5n", "gmf_s1_v2"), dtype=torch.float64, mode="exact",
                      **steps)
    after = spans.counters()
    assert after["merge_px_host"] - before["merge_px_host"] == m
    assert after["merge_px_card"] == before["merge_px_card"]
    assert K.launch_counts().get("dual_merge", 0) == 0


def test_memmapped_scene_through_the_lanes_equals_serial_on_card(cuda, tmp_path):
    """A scene of 2 x 2^22 + 1 px in ``.npy`` files memory-mapped back (the
    dtypes of a disk-fed archive chain) through ``invert_from_model`` at the
    default piece size: three pieces, the last of one pixel, read on the prep
    worker, merged on the card piece by piece, drained into fresh outputs; the
    serial loop's bits, every byte of the files read once."""
    from xsarsea_tpu_torch.utils import spans
    from xsarsea_tpu_torch.windspeed.inversion import _invert_source, _LazySource, _pieces

    steps = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    n = 2 * (1 << 22) + 1
    inc, s0_co, s0_cr, anc = _stream_scene(n, 24)
    scene = {"inc": inc.astype(np.float32), "s0_co": s0_co.astype(np.float32),
             "s0_cr": s0_cr.astype(np.float32),
             "dsig_cr": np.random.default_rng(24).uniform(0.05, 0.2, n).astype(np.float32),
             "anc": anc.astype(np.complex64)}
    for k, a in scene.items():
        np.save(tmp_path / f"{k}.npy", a)
    del scene
    files = {k: np.load(tmp_path / f"{k}.npy", mmap_mode="r")
             for k in ("inc", "s0_co", "s0_cr", "dsig_cr", "anc")}
    assert len(_pieces(n, 1 << 22)) == 3

    K.reset_launch_counts()
    before = spans.counters()
    co, dual = invert_from_model(files["inc"], files["s0_co"], files["s0_cr"],
                                 ancillary_wind=files["anc"], dsig_cr=files["dsig_cr"],
                                 model=("gmf_cmod5n", "gmf_s1_v2"), dtype=torch.float32,
                                 mode="fused", device=cuda, **steps)
    after = spans.counters()
    assert K.launch_counts()["dual_merge"] == 3
    assert after["pieces"] - before["pieces"] == 3
    assert after["merge_px_card"] - before["merge_px_card"] == n
    assert after["merge_px_host"] == before["merge_px_host"]
    assert after["read_bytes"] - before["read_bytes"] == 24 * n

    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, **steps)
    src = _LazySource((n,), files["inc"], s0_co=files["s0_co"], s0_cr=files["s0_cr"],
                      dsig_cr=files["dsig_cr"], anc=files["anc"])
    serial = _invert_source(tables, src, mode="fused", device=cuda, merge=True, _overlap=False)
    assert _same_bits(co, serial[0]) and _same_bits(dual, serial[1])
    assert np.isfinite(co).mean() > 0.99


@pytest.mark.parametrize("name", ["group_argmin", "group_argmin_streamed", "slab_refine_fused",
                                  "slab_refine", "crosspol_argmin"])
def test_indexed_kernel_bit_equal_to_the_kernel_on_the_copied_rows(cuda, name):
    """K1-K4 reading their rows through the bucket permutation (``index=``)
    against the same kernel through the identity permutation on the
    slot-order copy the fused path used to make, its results scattered back
    (``_bucket_copies``), at 2^22 + 57 px: a partial last block, padding
    slots, a coast of NaN s0; K1 reads an 8-float table as 4."""
    from _bucket_copies import kernel_case, run_both, same_bits

    n = (1 << 22) + 57
    args, kwargs = kernel_case(name, n, cuda, seed=22)
    K.reset_launch_counts()
    got, ref = run_both(name, args, kwargs)
    torch.cuda.synchronize()
    assert same_bits(got, ref)
    assert K.launch_counts()[name] == 2
    if name not in ("group_argmin", "group_argmin_streamed"):
        assert got.shape[-1] == n


def test_indexed_rows_table_checked_on_card(cuda):
    """The kernels refuse a rows table too narrow, one K1 and K4 cannot read
    as 16-byte rows and an index of another dtype or length; K3 through the
    permutation gives the same bits at every chunk height."""
    from _bucket_copies import kernel_case

    args, kw = kernel_case("group_argmin", 1000, cuda)
    rows, perm = args[4], kw["index"]
    with pytest.raises(ValueError, match="rows table"):
        K.group_argmin(*args[:4], rows[:, :2].contiguous(), *args[5:], index=perm)
    with pytest.raises(ValueError, match="16-byte"):
        K.group_argmin(*args[:4], rows[:, :6].contiguous(), *args[5:], index=perm)
    with pytest.raises(ValueError, match="index"):
        K.group_argmin(*args[:4], rows, *args[5:], index=perm.to(torch.int32))
    with pytest.raises(ValueError, match="index"):
        K.group_argmin(*args[:4], rows, *args[5:], index=perm[1:])
    args, kw = kernel_case("slab_refine", 1000, cuda)
    base = K.slab_refine(*args, **kw)
    for rows in K.CHUNK_ROWS:
        assert torch.equal(K.slab_refine(*args, **kw, chunk_rows=rows), base), rows
    args, kw = kernel_case("crosspol_argmin", 1000, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        K.crosspol_argmin(*args[:2], torch.zeros((1000, 5), device=cuda), args[3], **kw)


@pytest.mark.parametrize("cell", ["s1_iw_resident", "lut_scansar_resident"])
def test_fused_call_reads_through_the_permutation_on_card(cuda, cell, tmp_path, monkeypatch):
    """A coastal scene of the benchmark cell (its configuration's tables, its
    traffic's generator; ``s1_ew_resident`` shares the IW cell's
    configuration at 10^8 px) inverted on the card as the cell calls it: the
    winds equal bit for bit those of the same call with K1-K4 in their
    copying forms (the fused path before they read through the bucket
    permutation), and the call's record shows every slot launched read
    through an index (``perm_rows_read``)."""
    from pathlib import Path

    from _bucket_copies import copying_kernels, same_bits
    from benchmark import system, traffic
    from benchmark.entries import resident
    from benchmark.harness import Cell
    from xsarsea_tpu_torch.utils import trace

    root = Path(__file__).resolve().parents[1]
    c = Cell(root, cell)
    program = system.build(c.config, root, cuda)
    gen = traffic.generator(20, cuda)
    plan = next(p for p in traffic.scene_plan(c.traffic, gen) if p["land"] > 0)
    placed = resident.place(traffic.make_scene(c.traffic, c.config, gen, plan, cuda))
    assert torch.isnan(placed["s0_co_db"]).any()
    resident.invert(program, placed)  # build and warm up

    slots = []
    for name in K.KERNELS:
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _f=fn, **kw: slots.append(kw["index"].numel())
                            or _f(*a, **kw))
    with trace(tmp_path / "trace") as tr:
        co, dual = resident.invert(program, placed)
    monkeypatch.undo()
    rec, = tr.calls
    assert rec["perm_rows_read"] == sum(slots) > placed["inc"].numel()
    # the narrow sorts a piece: the incidence key's 32 bits and the
    # re-bucketing's 14 (501 incidences x 32 wind-speed groups), and in the
    # unfused tail the crosspol bands' 7 (67 incidences)
    sorts, bits = {"s1_iw_resident": (2, 46), "lut_scansar_resident": (3, 53)}[cell]
    assert rec["narrow_sorts"] == sorts * rec["pieces"] and rec["sort_bits"] == bits * rec["pieces"]
    with monkeypatch.context() as m:
        copying_kernels(m)
        ref_co, ref_dual = resident.invert(program, placed)
    assert same_bits(co, ref_co) and same_bits(dual, ref_dual)
    assert torch.isfinite(co).float().mean() > 0.5


@pytest.mark.parametrize("cross_axis", ["shared", "own"])
def test_resident_pieces_enqueue_with_no_host_wait_on_card(cuda, cross_axis, monkeypatch):
    """A 2-piece call with its inputs and results on the card, with the
    fused tail (K1, K2) or the unfused one (K1, K3, K4), runs from its start
    to its return under ``set_sync_debug_mode("error")``: nothing in it
    waits for the card, so the host runs ahead of it. Every launch's range
    guard is waived by the closure's marks and none reads back; the winds
    equal bit for bit those of the same call through the boolean-mask bucket
    assembly that read its masks back."""
    from _bucket_copies import masked_bucketing
    from xsarsea_tpu_torch.utils import spans

    kw = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    cr_kw = kw if cross_axis == "shared" else {**kw, "inc_step": 0.7}
    tables = InversionTables(get_model("gmf_cmod5n").to_lut(units="dB", **kw),
                             get_model("gmf_s1_v2").to_lut(units="dB", **cr_kw))
    n, piece = 1 << 17, 1 << 16
    pixels = _gmf_pixels(n, 22)
    dev = [torch.as_tensor(np.asarray(a, np.float32), device=cuda) for a in pixels[:4]]
    anc = torch.as_tensor(pixels[4].astype(np.complex64), device=cuda)

    def call():
        return invert_pixels(tables, *dev, anc, mode="fused", device=cuda, device_output=True,
                             piece_size=piece)

    call()  # builds the closure, which reads its tables back once
    torch.cuda.synchronize()
    before = spans.counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        co, dual = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = spans.counters()
    launches = 2 if cross_axis == "shared" else 3
    assert after["pieces"] - before["pieces"] == 2
    assert after["range_checks"] == before["range_checks"]
    assert after["range_checks_waived"] - before["range_checks_waived"] == 2 * launches
    # a piece's narrow sorts: one a bucketing, over the bits its keys hold
    bits = 32 + (len(tables.co_inc) * -(-len(tables.co_wspd) // K.WGROUP)).bit_length()
    if cross_axis == "own":
        bits += len(tables.cr_inc).bit_length()
    assert after["narrow_sorts"] - before["narrow_sorts"] == 2 * launches
    assert after["sort_bits"] - before["sort_bits"] == 2 * bits
    with monkeypatch.context() as m:
        masked_bucketing(m)
        ref_co, ref_dual = call()
    for got, ref in ((co, ref_co), (dual, ref_dual)):
        assert _same_bits(got.cpu().numpy(), ref.cpu().numpy())
    assert torch.isfinite(co).float().mean() > 0.99


def test_narrow_sort_equals_the_int64_sort_on_card(cuda):
    """The narrow radix sort at every key width from 1 to 32 bits equals
    ``torch.sort(stable=True)`` of the keys widened to int64, keys and
    payload (given, or the keys' indices) bit for bit, on 2^22 + 1 keys with
    heavy ties (and on a few small sizes); at 32 bits the keys span int32,
    signs included."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    for n in (0, 1, 255, (1 << 22) + 1):
        for end_bit in range(1, 33) if n > 255 else (1, 7, 14, 32):
            lo, hi = (-2 ** 31, 2 ** 31) if end_bit == 32 else (0, 2 ** end_bit)
            keys = torch.randint(lo, hi, (n,), generator=gen, device=cuda).to(torch.int32)
            keys[::3] = keys[:1].clone()  # heavy ties
            if end_bit == 32 and n > 4:
                keys[1:5] = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, 0], device=cuda)
            values = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
            ref_ks, order = torch.sort(keys.to(torch.int64), stable=True)
            for payload, ref in ((values, values[order]), (None, order.to(torch.int32))):
                ks, vs = K.sort_pairs(keys, end_bit, payload)
                assert ks.dtype == vs.dtype == torch.int32, (n, end_bit)
                assert torch.equal(ks.to(torch.int64), ref_ks), (n, end_bit)
                assert torch.equal(vs, ref), (n, end_bit, payload is None)


def test_f32_sort_key_kernel_equals_its_plain_version_on_every_float(cuda):
    """The ``f32_sort_key`` kernel against its plain version on all 2^32
    float32 bit patterns (NaN payloads of both signs, denormals, +-0,
    +-inf), 2^28 at a time."""
    step = 1 << 28
    for start in range(-2 ** 31, 2 ** 31, step):
        bits = torch.arange(start, start + step, dtype=torch.int64, device=cuda).to(torch.int32)
        v = bits.view(torch.float32)
        assert torch.equal(K.f32_sort_key(v), K._f32_sort_key_plain(v)), start


@pytest.mark.parametrize("route", ["by_value", "by_band", "by_band_iota", "by_band_sorted"])
def test_bucketings_equal_the_int64_sort_on_card(cuda, route):
    """Each bucketing on 2^22 + 57 pixels at the cells' key widths (the
    501-incidence grid's 32-bit key, the re-bucketing's 16,032 bands with
    sentinels and its payload, a 67-band crosspol axis) gives ``perm`` and
    ``band_of_block`` bit-identical to the stable int64 sort it replaced."""
    import _bucket_copies as C
    from xsarsea_tpu_torch.ops import bucketing as B

    rng = np.random.default_rng(26)
    n = (1 << 22) + 57
    dev = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    if route == "by_value":
        grid = np.linspace(17.0, 67.0, 501).astype(np.float32)
        vals = rng.uniform(15.0, 70.0, n).astype(np.float32)
        vals[::97] = np.nan
        vals[5::1001] = vals[5]  # ties
        vals[7], vals[9] = np.inf, -np.inf
        args = (dev(vals), dev(B._f32_sort_key_np(B.band_boundaries_f32(grid))), 501, 256)
    elif route == "by_band":
        n_bands = 501 * 32
        band = rng.integers(0, n_bands + 1, n)  # n_bands: a sentinel
        band[::5] = n_bands
        args = (dev(band), n_bands, 128, dev(rng.permutation(n)))
    elif route == "by_band_iota":
        args = (dev(rng.integers(0, 67, n).astype(np.int32)), 67, 256)
    else:
        within = rng.uniform(0, 30, n).astype(np.float32)
        within[::13] = np.nan
        within[::7] = within[1]
        args = (dev(rng.integers(0, 502, n)), dev(within), 501, 256)
    name = {"by_value": "bucket_by_value", "by_band_sorted": "bucket_by_band_sorted"}.get(
        route, "bucket_by_band")
    perm, bob = getattr(B, name)(*args)
    ref_perm, ref_bob = getattr(C, "int64_" + name)(*args)
    assert perm.dtype == ref_perm.dtype == torch.int64 and torch.equal(perm, ref_perm)
    assert bob.dtype == ref_bob.dtype and torch.equal(bob, ref_bob)


@pytest.mark.parametrize("route", ["by_band", "by_band_iota", "by_band_sorted"])
@pytest.mark.parametrize("outside", ["above", "negative"])
def test_a_band_outside_the_range_is_a_sentinel_on_card(cuda, outside, route):
    """On the card, where the narrow sort reads only the key bits that
    ``n_bands`` needs, a band outside ``[0, n_bands)`` (above those bits or
    below 0) is dropped as the sentinel ``n_bands`` is, bit-identical to the
    int64 sort of the bands with those set to ``n_bands``, at 2^22 + 57
    pixels and the re-bucketing's 16,032 bands."""
    import _bucket_copies as C
    from xsarsea_tpu_torch.ops import bucketing as B

    band, as_sentinel, n_bands, block = C.outside_band_case(outside, (1 << 22) + 57, 501 * 32,
                                                            seed=26)
    got = C.bucket_route(B, route, band, n_bands, block, seed=27, device=cuda)
    ref = C.bucket_route(C, route, as_sentinel, n_bands, block, seed=27, reference=True,
                         device=cuda)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_nesz_chain_on_card_equals_the_three_calls_and_the_reference(cuda):
    """xsarsea's L1 chain in one call on the card (``dsig_cr="gmf_s1_v2"``,
    ``nesz_cr=``), float32 tables on the fused path, 512 x 1,024 px in
    pieces that split rows: the weights against the plain float64 reference
    (``tests/_prep_reference.py``) to rtol 1e-9, as on the CPU (normal
    equations against sums about the means); the winds bit for bit those of
    the example's three calls on the card and of the serial loop; and, judged
    with the reference's ``dsig_cr`` by the benchmark's judge, within the
    fused path's limits of the benchmark's cells (a miss share of 0.01, a
    crosspol gap of 0.001: the coarse pass may miss a near-equal second
    minimum, float32 costs tie to ~1e-5)."""
    import _prep_reference as ref
    from benchmark.reference.judge import Judge, sample_inputs_f64, MISS_GAP
    from xsarsea_tpu_torch.utils import spans
    from xsarsea_tpu_torch.windspeed.inversion import _invert_source, _LazySource, _pieces

    steps = dict(inc_step=0.5, wspd_step=0.2, phi_step=2.5)
    models = ("gmf_cmod5n", "gmf_s1_v2")
    ny, nx, piece = 512, 1024, 100_000
    rng = np.random.default_rng(31)
    inc = np.linspace(30.0, 46.0, nx)[None, :] + rng.normal(0.0, 0.01, (ny, nx))
    speed = rng.uniform(2.0, 25.0, (ny, nx))
    direc = rng.uniform(-np.pi, np.pi, (ny, nx))
    dev = [torch.as_tensor(a, device=cuda) for a in (inc, speed, np.abs(np.rad2deg(direc)))]
    s0_co = (get_model(models[0])(*dev, broadcast=True).cpu().numpy()
             * rng.uniform(0.95, 1.05, (ny, nx))).astype(np.float32)
    s0_cr = (get_model(models[1])(dev[0], dev[1], broadcast=True).cpu().numpy()
             * rng.uniform(0.9, 1.1, (ny, nx))).astype(np.float32)
    s0_co[100:200, :300] = np.nan
    db = -25.0 + 0.1 * (inc - 30.0) + np.array([0.0, 1.0, -0.5])[np.arange(nx) * 3 // nx] \
        + rng.normal(0.0, 0.15, (ny, nx))
    nesz = (10.0 ** (db / 10.0)).astype(np.float32)
    nesz.reshape(-1)[rng.choice(ny * nx, 64, replace=False)] = np.nan
    anc = (speed + rng.normal(0, 1.5, (ny, nx))).clip(0.2) * np.exp(1j * direc)
    call = dict(ancillary_wind=anc, model=models, piece_size=piece, device=cuda,
                dtype=torch.float32, **steps)

    want = ref.dsig_from_nesz("gmf_s1_v2", inc, s0_cr.astype(np.float64),
                              nesz.astype(np.float64)).numpy()
    src = _LazySource((ny, nx), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr="gmf_s1_v2", anc=anc,
                      device_db=True, nesz_cr=nesz)
    src.fit_nesz(cuda)
    got = torch.cat([src._weights.dsig(lo, hi, torch.as_tensor(s0_cr.reshape(-1)[lo:hi],
                                                               device=cuda))
                     for lo, hi in _pieces(ny * nx, piece)]).cpu().numpy().reshape(ny, nx)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert src.rows_nan() == 0

    before = spans.counters()
    K.reset_launch_counts()
    co, du = invert_from_model(inc, s0_co, s0_cr, dsig_cr="gmf_s1_v2", nesz_cr=nesz, **call)
    counts, after = K.launch_counts(), spans.counters()
    assert counts["group_argmin"] == counts["slab_refine_fused"] == counts["dual_merge"] == 6
    assert after["nesz_rows"] - before.get("nesz_rows", 0) == ny
    assert after["dsig_px"] - before.get("dsig_px", 0) == ny * nx
    # the one call fits in float64 whatever the NESZ's dtype; nesz_flattening
    # keeps its input's: the three calls take the float32 NESZ's float64 values
    flat = nesz_flattening(nesz.astype(np.float64), inc, device=cuda)
    dsig3 = get_dsig("gmf_s1_v2", inc, s0_cr, flat, device=cuda)
    co3, du3 = invert_from_model(inc, s0_co, s0_cr, dsig_cr=dsig3, **call)
    assert _same_bits(co, co3) and _same_bits(du, du3)
    tables = prepare_tables(*models, dtype=torch.float32, **steps)
    src = _LazySource((ny, nx), inc, s0_co=s0_co, s0_cr=s0_cr, dsig_cr="gmf_s1_v2", anc=anc,
                      nesz_cr=nesz)
    src.fit_nesz(cuda)
    s_co, s_du = _invert_source(tables, src, device=cuda, piece_size=piece, merge=True,
                                _overlap=False)
    assert _same_bits(s_co.reshape(ny, nx), co) and _same_bits(s_du.reshape(ny, nx), du)

    judge = Judge(tables, 0.1, cuda)
    idx = np.unique(rng.integers(0, ny * nx, 16384))
    db_of = lambda a: 10.0 * np.log10(a.reshape(-1)[idx].astype(np.float64) + 1e-15)  # noqa
    x = sample_inputs_f64({"inc": inc.reshape(-1)[idx], "s0_co_db": db_of(s0_co),
                           "s0_cr_db": db_of(s0_cr), "dsig_cr": want.reshape(-1)[idx],
                           "anc_re": anc.real.reshape(-1)[idx],
                           "anc_im": anc.imag.reshape(-1)[idx]})
    verdict = judge.judge({k: v.to(cuda) for k, v in x.items()},
                          torch.as_tensor(co.reshape(-1)[idx], device=cuda),
                          torch.as_tensor(du.reshape(-1)[idx], device=cuda), merged=True)
    miss = (verdict["co_gap"] > MISS_GAP) | verdict["post_error"]
    assert float(miss.double().mean()) <= 0.01
    assert float(verdict["dual_gap"].max()) <= 1e-3
