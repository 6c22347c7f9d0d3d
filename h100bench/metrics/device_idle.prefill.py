"""``device_idle.prefill``: the share of the traced window of the prefill cells in
which no kernel or copy ran on the device (the union of the device's
intervals in the profiler's trace), in %."""

from h100bench.readers import device_idle


def read(run):
    return device_idle(run)
