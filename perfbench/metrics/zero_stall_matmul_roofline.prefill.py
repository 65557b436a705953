"""zero_stall_matmul_roofline.prefill: the least time of the zero-stall
products of the traced slice's admissions (every projection and the MLP
at the prompt's tokens, the head at its last) over the device time of
their kernels, in %.  Layer: the kernels (``kernels/zero_stall_matmul.py``);
moves ``ttft_p95_ms``."""

from perfbench import readers, roofline


def read(run):
    return readers.roofline_share(
        run, "serve.admit", readers.ZERO_STALL,
        lambda s: roofline.step_products(run.spec, s["prompt_len"],
                                         prefill=True))
