"""dispatch_ms.decode: the median ``serve.dispatch`` span of the window
over its K decode steps, in ms a step.  Layer: the engine
(``serve/engine.py``); moves ``out_tok_s``."""

from perfbench import readers


def read(run):
    return readers.median([1e3 * s["dur_s"] / s["k"]
                           for s in readers.spans(run, "serve.dispatch")])
