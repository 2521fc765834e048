"""Microbenchmark: row-gather cost against the source table's size.

Port of ``scripts/bench_gather_sizes.py``. The fused inversion once moved
pixels between pixel order and bucket order with row gathers from n-row
tables (``pix[perm]``, ``pix[perm2]``) and a scatter back (``res[:, dst]``);
its kernels now read and write through the permutation instead (``index=``
in ``ops/inversion_kernels.py``), and these timings are what that saves. An
alternative emits one i32 index a pixel
and decodes values in pixel order from the small (n_wspd * n_phi, 4) decode
table: worth it only if a gather from a cache-resident table is much cheaper
than one from an n-row table in HBM. At n = 2**23 this times, CUDA events,
median of 3 after a warm-up:

* the packed (n, 4) f32 row gather from an n-row table, and from the 87k-row
  decode table (481 x 181, the JAX script's size);
* the (n, 8) f32 row gather the port's stage 2 does;
* the (n,) i32 gather from an n-row table and the inverse-permutation
  scatter;
* the JAX script's alternative stage 3 (scatter, i32 gather, small-table
  decode, at rows drawn at random where the JAX script clips its random
  values to the table's last row) against its shipped one (scatter, (n, 4)
  gather).

Run: ``python -m xsarsea_tpu_torch.scripts.bench_gather_sizes`` on the card;
:func:`main` with ``device="cpu"`` (and a small ``n``) on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.scripts import device_of, median_ms

N = 1 << 23
SMALL_ROWS = 481 * 181  # the (wspd, phi) decode table


def main(n=N, device="cuda", reps=3, log=print):
    """Time the gathers on ``n`` pixels; returns ``{"n", "rows": [(name,
    ms), ...]}``."""
    dev = device_of(device)
    rng = np.random.default_rng(0)

    def to_dev(a):
        return torch.as_tensor(a, device=dev)

    idx_big = to_dev(rng.permutation(n).astype(np.int64))
    big4 = to_dev(rng.standard_normal((n, 4)).astype(np.float32))
    big8 = to_dev(rng.standard_normal((n, 8)).astype(np.float32))
    small4 = to_dev(rng.standard_normal((SMALL_ROWS, 4)).astype(np.float32))
    idx_small = to_dev(rng.integers(0, SMALL_ROWS, n).astype(np.int64))
    vals_i32 = to_dev(rng.integers(0, 1 << 26, n).astype(np.int32))
    arange = torch.arange(n, device=dev)

    def inverse(i):
        out = torch.empty(n, dtype=torch.int64, device=dev)
        out[i] = arange
        return out

    rows = []
    for name, fn in (
            ("(n,4) f32 row gather, big table (n rows)", lambda: big4[idx_big]),
            ("(n,4) f32 row gather, small table (87k)", lambda: small4[idx_small]),
            ("(n,8) f32 row gather, big table (stage 2)", lambda: big8[idx_big]),
            ("(n,) i32 gather, big table", lambda: vals_i32[idx_big]),
            ("(n,) scatter (inverse-perm build)", lambda: inverse(idx_big)),
            ("alt stage 3: scatter + i32 gather + decode",
             lambda: small4[vals_i32[inverse(idx_big)].to(torch.int64) % SMALL_ROWS]),
            ("shipped stage 3: scatter + (n,4) gather", lambda: big4[inverse(idx_big)])):
        _, ms = median_ms(fn, dev, reps)
        rows.append((name, ms))
        log(f"{name:44s} {ms:9.3f} ms   {ms * 1e6 / n:7.3f} ns/px")
    return {"n": n, "rows": rows}


if __name__ == "__main__":
    main()
