"""flash_attention_roofline.prefill: the least time of the causal prefill
attention of the traced slice's admissions (at the prompt's tokens, every
layer) over the device time of the flash kernels, in %.  Layer: the
kernels (``kernels/flash_attention.py``); moves ``ttft_p95_ms``."""

from perfbench import readers, roofline


def read(run):
    return readers.roofline_share(
        run, "serve.admit", readers.FLASH,
        lambda s: [roofline.flash_prefill(run.spec, s["prompt_len"])])
