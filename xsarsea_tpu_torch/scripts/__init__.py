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


def cuda_ms_turns(fns, rounds=3, reps=1):
    """``{name: median device ms}`` of each ``fns[name]()`` (a dict of
    callables): one warm-up each, then ``rounds`` rounds that time each in
    turn, forward in even rounds and backward in odd ones (a, b, b, a, ...),
    each reading the mean of ``reps`` calls between two CUDA events. Two
    versions compared this way share the card's state of the moment."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: statistics.median(t) for name, t in times.items()}


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
