"""mfu.decode_step: the model FLOPs of the decode tokens of the window's
``serve.dispatch`` spans over the spans' summed time and the bf16 peak,
in %: the whole decode step's share of the chip, which bounds the
kernels' rooflines at decode.  Layer: the model step; moves
``tpot_p95_ms``."""

from perfbench import readers, roofline


def read(run):
    sp = readers.spans(run, "serve.dispatch")
    if not sp:
        return None
    ends = set()
    for s in sp:
        for t0, t1, _ in run.log.steps:
            if t0 <= s["t"] and s["t"] + s["dur_s"] <= t1:
                ends.add(t1)
                break
    spec, flops = run.spec, 0.0
    for rid, times in run.log.times.items():
        n = run.prompt_len.get(rid)
        if n is None:
            continue
        flops += sum(spec.token_flops(n + j)
                     for j, t in enumerate(times) if j and t in ends)
    secs = sum(s["dur_s"] for s in sp)
    if flops <= 0:
        return None
    return 100.0 * flops / (secs * roofline.PEAK_BF16)
