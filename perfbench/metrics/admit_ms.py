"""admit_ms: the median ``serve.admit`` span of the window (a prompt's
prefill program, its install into the slot and its first token), in ms.
Layer: the prefill programs (``serve/engine.py``, ``graphs.py``); moves
``ttft_p95_ms``."""

from perfbench import readers


def read(run):
    return readers.median([1e3 * s["dur_s"]
                           for s in readers.spans(run, "serve.admit")])
