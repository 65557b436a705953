"""zero_stall_matmul_roofline.decode: the least time of the zero-stall
products of the traced slice's decode dispatches (kernels 1 and 5: every
projection, the expert banks and the head, at the dispatch's live slots,
K steps a dispatch) over the device time of their kernels (``sm90_kernel``,
``splitk_reduce``, ``ring_kernel``), in %.  Layer: the kernels
(``kernels/zero_stall_matmul.py``, ``kernels/grouped_matmul.py``); moves
``tpot_p95_ms``."""

from perfbench import readers, roofline


def read(run):
    return readers.roofline_share(
        run, "serve.dispatch", readers.ZERO_STALL,
        lambda s: roofline.step_products(run.spec, s["active"],
                                         prefill=False) * s["k"])
