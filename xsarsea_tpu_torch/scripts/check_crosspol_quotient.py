"""Hold the crosspol argmin's hoisted quotient against the true divide on
every pair of significands, on the GPU.

The crosspol loop of K4 and K2 (``xs::crosspol::argmin``,
``ops/csrc/inversion_common.cuh``) divides by a value that is constant per
pixel, so it multiplies by the correctly rounded reciprocal and corrects the
product by one residual step of two exact fused multiply-adds. Inside the
loop's operand windows no intermediate leaves the normal range, so whether
the result equals the correctly rounded quotient depends on the two
significands alone. This script settles it by exhaustion: for each of the
2**23 divisors in [1, 2) and each of the 2**23 dividends in [1, 2) (2**46
pairs, quotients in (1/2, 2)) it compares the hoisted quotient with
``__fdiv_rn`` bit for bit and counts the pairs that differ.

Run: ``python -m xsarsea_tpu_torch.scripts.check_crosspol_quotient
[--divisors N]``; ``--divisors`` (default all 2**23) takes that many
divisors, in runs of 256 evenly spread over [1, 2), for a shorter run. It
needs a CUDA device (about 50 s on an H100 for the whole sweep) and prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from xsarsea_tpu_torch.ops import experiment_kernels as E
from xsarsea_tpu_torch.scripts import device_of

SIGNIFICANDS = 1 << 23
LAUNCH = 1 << 16  # divisors per kernel launch of the whole sweep


def main(divisors=SIGNIFICANDS, device="cuda"):
    """Count the differing pairs over ``divisors`` divisors and all
    dividends; prints and returns the result as a dict."""
    dev = device_of(device)
    run = LAUNCH if divisors >= SIGNIFICANDS else 256
    starts = range(0, SIGNIFICANDS, run * max(1, SIGNIFICANDS // divisors))
    t0 = time.perf_counter()
    differing, examples = 0, []
    for b_first in starts:
        bad, ex = E.crosspol_quotient_sweep(b_first, run, dev)
        differing += bad
        examples = (examples + ex)[:16]
    result = {"divisors": len(starts) * run, "pairs": len(starts) * run * SIGNIFICANDS,
              "differing": differing, "examples_dividend_divisor": examples,
              "seconds": round(time.perf_counter() - t0, 1),
              "device": torch.cuda.get_device_name(dev)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--divisors", type=int, default=SIGNIFICANDS)
    main(parser.parse_args().divisors)
