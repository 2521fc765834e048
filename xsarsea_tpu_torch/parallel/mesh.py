"""A (data, model) device mesh, and the runner that puts work on its devices.

Counterpart of ``xsarsea_tpu.parallel.mesh``. JAX's ``shard_map`` is one
program driven by one host; so is this: no ``torch.distributed``, no process
group. Each shard's work runs on its device, with one host thread per
distinct device of the mesh (a device that appears several times runs its
shards one after the other on its thread), and the host joins the shards'
results. Pixels split over ``data``; the phi axis of the copol cost grid
splits over ``model``.

A device may repeat: ``make_mesh(8, devices=["cpu"] * 8)`` lays eight shards
on the host (the tests' mesh, as the JAX tests use eight host devices), and
``make_mesh(2, devices=["cuda:0"] * 2)`` two shards on one card. Such a mesh
is a layout for holding the sharded code to the one-device results, not a
faster one: its shards share one device.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["Mesh", "make_mesh", "run_on_devices"]


class Mesh:
    """``devices[i][j]``: the device of data shard ``i``, model shard ``j``.
    Hashable and compared by its devices, so it can key a cache."""

    __slots__ = ("devices",)

    def __init__(self, devices):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not self.devices or not self.devices[0] or \
                any(len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a mesh is a non-empty rectangle of devices")

    @property
    def shape(self):
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self):
        return len(self.devices) * len(self.devices[0])

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)


def make_mesh(n_data=None, n_model=1, devices=None):
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device). ``n_data`` defaults to ``len(devices) // n_model``; the first
    ``n_data * n_model`` devices fill the mesh row by row."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={n_data} model={n_model} "
                         f"({len(devices)} devices available)")
    n = n_data * n_model
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh([devices[i * n_model:(i + 1) * n_model] for i in range(n_data)])


def _on(device, fn):
    if device.type == "cuda":
        with torch.cuda.device(device):
            return fn()
    return fn()


def run_on_devices(tasks):
    """Run ``tasks``, a list of ``(device, fn)``, and return their results in
    order: one host thread per distinct device, each running its tasks in
    order with that device current; inline when there is only one device."""
    by_device = {}
    for k, (device, _) in enumerate(tasks):
        by_device.setdefault(torch.device(device), []).append(k)
    if len(by_device) <= 1:
        return [_on(torch.device(device), fn) for device, fn in tasks]
    results = [None] * len(tasks)
    errors = []

    def run(device, ks):
        try:
            for k in ks:
                results[k] = _on(device, tasks[k][1])
        except Exception as e:  # raised again on the calling thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=item) for item in by_device.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
