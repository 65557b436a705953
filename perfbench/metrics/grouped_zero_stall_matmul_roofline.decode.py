"""grouped_zero_stall_matmul_roofline.decode: kernel 5 alone.  The least
time of the expert banks' three products in every layer, at each matched
traced decode dispatch's live slots and K steps (each bank read whole,
as ``roofline.step_products`` counts them), over the device time of the
zero-stall kernels (``sm90_kernel``, ``splitk_reduce``, ``ring_kernel``)
in the ``moe.experts`` region of those dispatches, in %.  Layer: the
kernels (``kernels/grouped_matmul.py``); moves ``tpot_p95_ms``."""

from perfbench import readers, regions, roofline


def read(run):
    if run.spec.family != "moe":
        return None
    least = secs = 0.0
    for s, evs in regions.matched(run):
        secs += regions.region_seconds(evs, "moe.experts", readers.ZERO_STALL)
        least += s["k"] * sum(roofline.least_time(f, b) for f, b in
                              regions.expert_banks(run.spec, s["active"]))
    if secs <= 0:
        return None
    return 100.0 * least / secs
