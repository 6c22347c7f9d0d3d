"""``device_idle.nemotron_prefill``: the share of the traced window of the
Nemotron-H prefill cell in which no kernel or copy ran on the device (the
union of the device's intervals in the profiler's trace), in %: where the
host, a sync or a gap between launches holds the card back."""

from h100bench.readers import device_idle


def read(run):
    return device_idle(run)
