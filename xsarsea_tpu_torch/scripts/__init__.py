"""Experiment drivers and stage benchmarks of the port, one per script of
the JAX package's ``scripts/`` (run each with ``python -m
xsarsea_tpu_torch.scripts.<name>``), and what they share."""

import statistics
import time

import torch


def device_of(device):
    """The torch device to run on. A CUDA device that is absent is an error:
    the drivers measure the card, and run the CPU only when asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the drivers time the kernels on the card "
                           "(pass device='cpu' to run their plain versions)")
    return dev


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, from CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, device, reps=3):
    """(last output, median ms of ``reps`` runs of ``fn()`` after a warm-up):
    each run between two CUDA events on a card, on the host clock on the CPU."""
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)
