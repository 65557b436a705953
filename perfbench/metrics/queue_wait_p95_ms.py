"""queue_wait_p95_ms: for every admission of the window, the time from
when its request fell due to the start of its ``serve.admit`` span, the
95th percentile, in ms.  Layer: the engine (``serve/engine.py``); moves
``ttft_p95_ms``."""

from perfbench import readers
from perfbench.spec import percentile


def read(run):
    waits = [s["t"] - run.log.due[s["rid"]]
             for s in readers.spans(run, "serve.admit")
             if s["rid"] in run.log.due]
    return 1e3 * percentile(waits, 95) if waits else None
