"""device_idle_pct.rate: the share of the traced slice of a cell offered a
fixed request rate in which no device event ran (1 - the union of the
profiler's device events over the slice), in %.  Layer: the device;
moves ``ttft_p95_ms``."""

from perfbench import readers


def read(run):
    return readers.idle_pct(run)
