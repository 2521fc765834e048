"""Micro-benchmark the coarse pass's expanded-form variants (K6), on the GPU.

Port of ``scripts/bench_kernel_variants.py``: the TPU's coarse
group-argmin kernel as a K = 4 product ``g4[band, tile]^T . feats`` over
4 tiles x 2048 entries, reduced to 32 group rows per pixel, in isolation,
to price its components: the matmul precision (``highest`` float32, or
``default``, both operands rounded to bf16), the group-min reduction
(``reshape`` and ``static_slices``, two TPU codegen routes to one function
and one code path here; ``flat_min``, one row per tile; ``none``, no
reduction: the first 8 entries of a tile are its rows) and the pixel block
size. It runs the JAX script's nine variants at 2**23 pixels on random
operands drawn from ``numpy.random.default_rng(0)`` in the JAX script's
order (g4 first, then feats and the sorted bands per variant), and prints
each one's device time (CUDA events, mean of 3 after a warm-up) and rate.

On this card one thread evaluates each entry's product and folds it into
its group's minimum in registers, so a reduction costs one FP32 operation
per entry; ``none`` never reads the entries it would discard.

Run: ``python -m xsarsea_tpu_torch.scripts.bench_kernel_variants``. It
needs a CUDA device; :func:`main` runs the plain versions on the CPU only
when called with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.scripts import cuda_ms, device_of

N = 1 << 23
N_INC = 501
REPS = 3
# (label, block, reduction, precision): scripts/bench_kernel_variants.py:101-109
VARIANTS = (
    ("block=256 reshape HIGHEST (current)", 256, "reshape", "highest"),
    ("block=256 static_slices HIGHEST", 256, "static_slices", "highest"),
    ("block=256 flat_min HIGHEST", 256, "flat_min", "highest"),
    ("block=256 none HIGHEST", 256, "none", "highest"),
    ("block=256 none DEFAULT", 256, "none", "default"),
    ("block=512 reshape HIGHEST", 512, "reshape", "highest"),
    ("block=1024 reshape HIGHEST", 1024, "reshape", "highest"),
    ("block=1024 static_slices HIGHEST", 1024, "static_slices", "highest"),
    ("block=1024 none DEFAULT", 1024, "none", "default"),
)


def make_g4(rng):
    return rng.normal(size=(N_INC, E.G4_TILES, 4, E.G4_TILE)).astype(np.float32)


def make_inputs(rng, block, n):
    """One variant's feats (n_blocks, 4, block) and sorted band per block,
    drawn as the JAX script's ``make_variant`` draws them."""
    n_blocks = n // block
    feats = rng.normal(size=(n_blocks, 4, block)).astype(np.float32)
    band_of_block = np.sort(rng.integers(0, N_INC, n_blocks)).astype(np.int32)
    return feats, band_of_block


def main(n=N, device="cuda"):
    """Run the variants and print a line each. Returns a list of
    ``{"label", "args", "kwargs", "out", "ms", "mpx_s"}``; times are None
    on the CPU."""
    dev = device_of(device)
    rng = np.random.default_rng(0)
    g4 = torch.as_tensor(make_g4(rng), device=dev)
    print(f"pixels {n} | g4 {tuple(g4.shape)} | device {dev}", flush=True)
    results = []
    for label, block, reduction, precision in VARIANTS:
        feats, band_of_block = make_inputs(rng, block, n)
        args = (g4, torch.as_tensor(feats, device=dev), torch.as_tensor(band_of_block, device=dev))
        kwargs = dict(block=block, reduction=reduction, precision=precision)
        out = E.group_argmin_variant(*args, **kwargs)
        ms = cuda_ms(lambda: E.group_argmin_variant(*args, **kwargs), REPS) \
            if dev.type == "cuda" else None
        mpx_s = None if ms is None else n / ms / 1e3
        timing = "not timed (plain version on the CPU)" if ms is None else \
            f"{ms:8.3f} ms  {mpx_s:8.2f} Mpx/s"
        note = "  (one function with reshape on this card)" if reduction == "static_slices" \
            else ""
        print(f"{label:40s} {timing}{note}", flush=True)
        results.append({"label": label, "args": args, "kwargs": kwargs, "out": out, "ms": ms,
                        "mpx_s": mpx_s})
    return results


if __name__ == "__main__":
    main()
