"""admit_stall_pct: the summed time of the window's ``serve.admit`` and
``serve.prefill_chunk`` spans that held live decoding slots back
(``decoding`` > 0), over the window, in %: the share of the window in
which decoding slots waited behind an admission.  The profiled slice is
left out of both, with the seconds the profiler held the host: inside
the slice the profiler slows every eager launch of an admission, so its
spans would read the profiler as well as the engine.  Layer: the engine
(``serve/engine.py``); moves ``tpot_p95_ms``."""

from perfbench import readers


def read(run):
    sp = readers.spans(run, "serve.admit") \
        + readers.spans(run, "serve.prefill_chunk")
    if not any("decoding" in s for s in sp):
        return None
    w0, w1 = run.window
    rest = w1 - w0 - run.held_s
    if run.trace_window is not None:
        lo, hi = run.trace_window
        sp = [s for s in sp if s["t"] + s["dur_s"] <= lo or s["t"] >= hi]
        rest -= hi - lo
    if rest <= 0:
        return None
    held = sum(s["dur_s"] for s in sp if s.get("decoding", 0) > 0)
    return 100.0 * held / rest
