"""The cost of the port's spans (:mod:`xsarsea_tpu_torch.utils.spans`): the
nanoseconds one ``span()`` takes to enter and leave with no profiler
running (``off_ns``) and with ``torch.profiler`` running (``on_ns``: CPU
activity, and CUDA activity on a card), and one counter's add
(``count_ns``); each the best of three loops, less the empty loop's time.

    python -m xsarsea_tpu_torch.scripts.bench_spans

prints one JSON line. ``off_ns`` times the spans a call enters is what the
spans cost every call; ``on_ns`` times the spans a traced window holds is
what they add to it.
"""

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from xsarsea_tpu_torch.scripts import device_of
from xsarsea_tpu_torch.utils import spans

_COUNTER = "bench_spans"


def _ns_per(loop, n):
    """Nanoseconds per iteration of ``loop(n)``, the best of three."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        loop(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def _empty(n):
    for _ in range(n):
        pass


def _spans(n):
    for _ in range(n):
        with spans.span("xs.bench"):
            pass


def _counts(n):
    for _ in range(n):
        spans.count(_COUNTER)


def main(n=1_000_000, n_on=20_000, device="cuda"):
    dev = device_of(device)
    empty = _ns_per(_empty, n)
    off = _ns_per(_spans, n) - empty
    count = _ns_per(_counts, n) - empty
    spans.reset(_COUNTER)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        on = _ns_per(_spans, n_on) - empty
    record = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "torch": torch.__version__, "n": n, "n_on": n_on, "off_ns": off, "on_ns": on,
              "count_ns": count}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
