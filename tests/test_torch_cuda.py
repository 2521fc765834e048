"""The CUDA kernels on the card, against their plain PyTorch versions and
the exact path. Needs a CUDA device and nvcc; skipped elsewhere.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.ops import inversion_kernels as K
from xsarsea_tpu_torch.windspeed.inversion import invert_pixels, prepare_tables

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
    got1 = K.group_argmin(*args1)
    ref1 = K._group_argmin_plain(*args1, block=256)
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
    got2 = K.slab_refine_fused(*args2)
    ref2 = K._slab_refine_fused_plain(*args2, has_cr=True, block=128)
    torch.cuda.synchronize()
    assert torch.equal(got2, ref2)
    assert (got2[0, 0] == 0).any()  # the NaN LUT entry poisons some of block 0's pixels
    assert K.launch_counts() == {"group_argmin": 1, "slab_refine_fused": 1}


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
    assert min(K.launch_counts().values()) >= 1
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
    with pytest.raises(ValueError, match="contiguous"):
        K.group_argmin(torch.zeros((1, 2, 2), device=cuda), torch.zeros((2, 2), device=cuda),
                       torch.zeros((2, 2), device=cuda),
                       torch.zeros(2, dtype=torch.int32, device=cuda), feats,
                       torch.zeros(1, dtype=torch.int64, device=cuda), 1)
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
        K.slab_refine_fused(*ops, one * 2, one * 0, one)  # band 2 of a 2-band LUT
    with pytest.raises(ValueError, match="srow0"):
        K.slab_refine_fused(*ops, one * 0, one * (wp - K.SLAB_ROWS + 1), one)
