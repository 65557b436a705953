"""device_idle_pct.decode: the share of the traced slice of a decode-heavy
cell in which no device event ran (1 - the union of the profiler's
device events over the slice), in %.  Layer: the device; moves
``out_tok_s``."""

from perfbench import readers


def read(run):
    return readers.idle_pct(run)
