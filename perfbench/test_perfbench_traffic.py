"""The traffic generator: the same schedule from the same seed, and the
same work in another order from another."""

import collections

import pytest

from perfbench.spec import load_cell
from perfbench.traffic import Traffic

MIX = {"loop": "open", "rate_per_s": 5.0, "block": 16,
       "prompt_len": {"median": 100, "sigma": 0.7, "min": 20, "max": 400},
       "output_len": {"median": 30, "sigma": 0.5, "min": 4, "max": 90},
       "sampling": {"temperature": 0.8, "top_p": 0.9, "top_k": 0},
       "greedy_share": 0.25}


def _schedule(seed, n=48):
    t = Traffic(MIX, seed, 1000)
    return [(t.request(i), t.arrival(i)) for i in range(n)]


def test_same_seed_same_schedule():
    assert _schedule(2 ** 31 + 11) == _schedule(2 ** 31 + 11)


def test_other_seed_same_work_other_content():
    a, b = _schedule(3), _schedule(4)
    assert [r.prompt for r, _ in a] != [r.prompt for r, _ in b]
    assert [r.temperature for r, _ in a] != [r.temperature for r, _ in b]
    # the seed draws the order of each block's sizes and gaps, not the set
    assert [len(r.prompt) for r, _ in a] != [len(r.prompt) for r, _ in b]
    assert [r.max_new_tokens for r, _ in a] != \
        [r.max_new_tokens for r, _ in b]
    assert [t for _, t in a] != [t for _, t in b]
    for blk in range(3):
        ra, rb = (x[16 * blk:16 * (blk + 1)] for x in (a, b))
        for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens,
                    lambda r: r.temperature == 0.0):
            assert collections.Counter(key(r) for r, _ in ra) == \
                collections.Counter(key(r) for r, _ in rb)
        assert ra[-1][1] == pytest.approx(rb[-1][1])
        assert sorted(_gaps(ra, a, blk)) == pytest.approx(
            sorted(_gaps(rb, b, blk)))


def _gaps(block, schedule, blk):
    start = schedule[16 * blk - 1][1] if blk else 0.0
    times = [start] + [t for _, t in block]
    return [y - x for x, y in zip(times, times[1:])]


def test_lengths_and_shares_follow_the_mix():
    reqs = [r for r, _ in _schedule(9, 64)]
    assert all(20 <= len(r.prompt) <= 400 for r in reqs)
    assert all(4 <= r.max_new_tokens <= 90 for r in reqs)
    assert sum(r.temperature == 0.0 for r in reqs) == 16
    assert all(0 <= t < 1000 for r in reqs for t in r.prompt)
    arrivals = [a for _, a in _schedule(9, 64)]
    assert arrivals == sorted(arrivals)
    assert arrivals[-1] == pytest.approx(64 / 5.0, rel=0.2)


def test_residual_keeps_the_prompt_and_cuts_the_output():
    t = Traffic(MIX, 5, 1000)
    for i in range(20):
        full, res = t.request(i), t.request(i, residual=True)
        assert res.prompt == full.prompt and res.seed == full.seed
        assert 1 <= res.max_new_tokens <= full.max_new_tokens


@pytest.mark.parametrize("cell", ["olmoe.decode_heavy", "mistral.long_prompt"])
def test_cells_fit_their_engine(cell):
    c = load_cell(cell)
    mix, eng = c.traffic, c.traffic["engine"]
    assert mix["prompt_len"]["max"] + mix["output_len"]["max"] \
        <= eng["max_len"]
    t = Traffic(mix, 1, c.config["vocab_size"])
    assert t.prompt_range()[1] <= mix["prompt_len"]["max"]
