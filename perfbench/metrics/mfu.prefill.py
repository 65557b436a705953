"""mfu.prefill: the model FLOPs of the window's prefills (each prompt's
products and causal attention, the head on its last token) over the
summed ``serve.admit`` time and the bf16 peak, in %.  Layer: the model
step; moves ``ttft_p95_ms``."""

from perfbench import readers, roofline


def read(run):
    sp = readers.spans(run, "serve.admit")
    if not sp:
        return None
    flops = sum(run.spec.prefill_flops(s["prompt_len"]) for s in sp)
    return 100.0 * flops / (sum(s["dur_s"] for s in sp)
                            * roofline.PEAK_BF16)
