"""mfu.decode: the model FLOPs of every token that reached the harness in
the window (a first token: its prompt's prefill; a later one: its
products and its attention over the context), over the window (less the
seconds the profiler held the host) and the bf16 peak, in %.  Layer: the
model step (``models/transformer.py``, ``moe.py``, ``layers.py``); moves
``out_tok_s``."""

from perfbench import roofline


def read(run):
    w0, w1 = run.window
    spec, flops = run.spec, 0.0
    for rid, times in run.log.times.items():
        n = run.prompt_len.get(rid)
        if n is None:
            continue
        for j, t in enumerate(times):
            if w0 <= t < w1:
                flops += (spec.prefill_flops(n) if j == 0
                          else spec.token_flops(n + j))
    if flops <= 0:
        return None
    return 100.0 * flops / ((w1 - w0 - run.held_s) * roofline.PEAK_BF16)
