"""Multi-scene batch inversion over a device mesh (BASELINE config #5).

Port of ``examples/multichip_batch.py``: shards a batch of dual-pol scenes
over the mesh's ``data`` axis and runs the fused pipeline on each shard. The
port's mesh is one process with one host thread a distinct device, and a
device may repeat: this example names ``device`` twice (``data`` = 2), so it
runs anywhere, on one card or on the CPU, without any virtual device count;
on a host with several cards, pass their names to ``make_mesh``.
"""

from __future__ import annotations

import numpy as np
import torch

from xsarsea_tpu_torch.models import get_model
from xsarsea_tpu_torch.parallel import invert_scenes, make_mesh
from xsarsea_tpu_torch.utils import resolve_device
from xsarsea_tpu_torch.windspeed import prepare_tables


def make_scene(h, w, seed, device="cuda"):
    """The JAX example's scene (same draws), sigma0 forward-modelled in
    float64 on ``device``, as ``invert_scenes`` takes it (dB)."""
    rng = np.random.default_rng(seed)
    inc = np.linspace(20.0, 45.0, w)[None, :].repeat(h, 0)
    wspd = rng.uniform(3.0, 22.0, (h, w))
    wdir = rng.uniform(0.0, 360.0, (h, w))
    inc_t, wspd_t, wdir_t = (torch.as_tensor(a, device=device) for a in (inc, wspd, wdir))
    s0_co = get_model("gmf_cmod5n")(inc_t, wspd_t, wdir_t, broadcast=True).cpu().numpy()
    s0_cr = get_model("gmf_s1_v2")(inc_t, wspd_t, broadcast=True).cpu().numpy()
    anc = (wspd + rng.normal(0, 1.5, (h, w))).clip(0.2) * np.exp(1j * np.deg2rad(wdir))
    return dict(inc=inc, sigma0_co_db=10 * np.log10(s0_co + 1e-15),
                sigma0_cr_db=10 * np.log10(s0_cr + 1e-15), dsig_cr=np.full((h, w), 0.1),
                ancillary_wind=anc), wspd


def main(device="cuda", h=96, w=128, n_scenes=3):
    dev = resolve_device(device)
    name = f"cuda:{dev.index if dev.index is not None else torch.cuda.current_device()}" \
        if dev.type == "cuda" else str(dev)
    mesh = make_mesh(2, 1, devices=[name] * 2)
    print(f"mesh: 2 x data, both {name} (one device named twice: a layout check)")

    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=torch.float32, inc_step=0.5,
                            wspd_step=0.5, phi_step=5.0)
    scenes, truths = zip(*[make_scene(h, w, s, device=dev) for s in range(n_scenes)])
    outs = invert_scenes(tables, list(scenes), mesh, mode="fused")

    rms = []
    for i, ((co, dual), truth) in enumerate(zip(outs, truths)):
        rms.append(float(np.sqrt(np.nanmean((np.abs(dual) - truth) ** 2))))
        print(f"scene {i}: shape {co.shape}, dual-pol RMS vs truth {rms[-1]:.2f} m/s")
    if not max(rms) < 1.0:
        raise RuntimeError(f"multichip_batch: RMS {rms} m/s, expected < 1.0 for each scene")
    return {"rms": rms}


if __name__ == "__main__":
    main()
