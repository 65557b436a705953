"""decode_sample_ms.decode: the device time of the ``decode.sample``
region (the sampler: greedy argmax, or the threefry draw, sort and
filters of a sampled step) in each traced decode dispatch whose events
matched its graph's map, over the dispatch's K steps; the median over
dispatches, in ms a step.  Layer: the model step (``serve/sampling.py``
inside the decode graph); moves ``tpot_p95_ms``."""

from perfbench import readers, regions


def read(run):
    return readers.median([
        1e3 * regions.region_seconds(evs, "decode.sample") / s["k"]
        for s, evs in regions.matched(run)])
