"""decode_attention_ms.decode: the device time of the ``attention.core``
region (scores, mask, softmax, the value product and the layout copies
they make, in every layer) in each traced decode dispatch whose events
matched its graph's map, over the dispatch's K steps; the median over
dispatches, in ms a step.  Layer: the model step
(``models/layers.py``); moves ``tpot_p95_ms``."""

from perfbench import readers, regions


def read(run):
    return readers.median([
        1e3 * regions.region_seconds(evs, "attention.core") / s["k"]
        for s, evs in regions.matched(run)])
