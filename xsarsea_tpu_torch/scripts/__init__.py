"""Experiment drivers of the port, one per script of the JAX package's
``scripts/`` whose kernels it ports (run each with ``python -m
xsarsea_tpu_torch.scripts.<name>``), and what they share."""

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
