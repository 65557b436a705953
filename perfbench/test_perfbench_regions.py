"""The region readers on synthetic runs: a traced dispatch's device events
(those between its copy in and its copy out) are labelled by its graph's
map only where their count matches it, whatever the drift of the device
clock against the span; the ms and roofline arithmetic, the admission
stall's share of the window outside the profiled slice, the breakdown by
region, and None where nothing matched, as on a
program that emits no map."""

import json
import subprocess
import sys

import pytest

from perfbench import e2e, region_breakdown, regions, roofline
from perfbench.harness import Run
from perfbench.spec import ROOT, metric_reader, model_spec

OLMOE = model_spec(json.loads(
    (ROOT / "perfbench/configs/olmoe-1b-7b.json").read_text()))
MS = 1e-3
# a graph of five device nodes
RUNS = [["decode.model", 0, 1], ["attention.core", 1, 3],
        ["moe.experts", 3, 4], ["decode.sample", 4, 5]]
KERNELS = ["elementwise_kernel<128, 4>", "direct_copy_kernel_cuda",
           "elementwise_kernel<128, 4>", "void sm90_kernel<bf16, 2, 16>",
           "radix_sort"]


def _event(variant="sampled", runs=RUNS):
    return {"type": "event", "name": "graphs.regions", "t": 0.0,
            "variant": variant, "nodes": runs[-1][2], "runs": runs}


def _dispatch(t, kernels, *, variant="sampled", k=4, active=32,
              dur=1.0 * MS, copies=True, drift=0.0):
    """A dispatch span at ``t`` and its device events, each ``dur`` long
    (with the copy in before and the copy out after them), put ``drift``
    seconds off the span's clock."""
    span = {"type": "span", "name": "serve.dispatch", "t": t,
            "dur_s": (len(kernels) + 3) * dur, "step": 1, "k": k,
            "active": active}
    if variant is not None:
        span["variant"] = variant
    names = list(kernels)
    if copies:
        names = ["Memcpy HtoD (Pinned -> Device)"] + names \
            + ["Memcpy DtoH (Device -> Pageable)"]
    evs = [(n, t + drift + (i + 1) * dur, t + drift + (i + 1.5) * dur)
           for i, n in enumerate(names)]
    return span, evs


def _run(dispatches, events=(), others=(), window=(0.0, 10.0),
         held_s=0.0, trace_window=(0.0, 10.0)):
    spans = list(events) + list(others)
    device = []
    for span, evs in dispatches:
        spans.append(span)
        device += evs
    return Run(spec=OLMOE, window=window, log=e2e.Log(), spans=spans,
               device=device, trace_window=trace_window, prompt_len={},
               held_s=held_s)


def test_count_check_skips_a_span_that_does_not_match():
    good = _dispatch(1.0, KERNELS)
    short = _dispatch(2.0, KERNELS[:-1])                 # one event short
    unmapped = _dispatch(3.0, KERNELS, variant="greedy")
    parent = _dispatch(4.0, KERNELS, variant=None)       # no variant named
    bare = _dispatch(5.0, KERNELS, copies=False)         # no copies seen
    early = _dispatch(6.0, KERNELS, drift=-2.5 * MS)     # the clock drifts
    late = _dispatch(7.0, KERNELS, drift=+2.5 * MS)
    run = _run([good, short, unmapped, parent, bare, early, late],
               events=[_event()])
    got = regions.dispatches(run)
    assert [evs is not None for _, evs in got] == [
        True, False, False, False, False, True, True]
    (s, evs), _, _ = regions.matched(run)
    assert s is good[0]
    assert [(n, lab) for n, _, _, lab in evs] == list(zip(
        KERNELS, ["decode.model", "attention.core", "attention.core",
                  "moe.experts", "decode.sample"]))
    # events outside a dispatch's copies are not read
    stray = _run([good], events=[_event()])
    stray.device.append(("stray", 0.5, 0.6))
    assert len(regions.matched(stray)) == 1


def test_region_ms_a_step_is_the_median_over_matched_dispatches():
    spans = [_dispatch(1.0, KERNELS, dur=1.0 * MS),
             _dispatch(2.0, KERNELS, dur=2.0 * MS),
             _dispatch(3.0, KERNELS, dur=3.0 * MS),
             _dispatch(4.0, KERNELS[:3], dur=9.0 * MS)]  # not matched
    run = _run(spans, events=[_event()])
    # attention.core: two events of dur/2 each, over K = 4 steps
    assert metric_reader("decode_attention_ms.decode")(run) == \
        pytest.approx(2.0 * 0.5 * 2.0 / 4)
    assert metric_reader("decode_sample_ms.decode")(run) == \
        pytest.approx(0.5 * 2.0 / 4)


def test_grouped_roofline_reads_the_expert_banks_alone():
    kernels = ["void sm90_kernel<bf16, 2, 16>",      # a projection: not read
               "void sm90_kernel<bf16, 2, 16>", "splitk_reduce<bf16>",
               "elementwise_kernel<silu>",            # in the region, no zs
               "radix_sort"]
    runs = [["attention.qkv", 0, 1], ["moe.experts", 1, 4],
            ["decode.sample", 4, 5]]
    d = _dispatch(1.0, kernels, k=4, active=32, dur=2.0 * MS)
    run = _run([d], events=[_event(runs=runs)])
    secs = 2 * 1.0 * MS                       # two zero-stall events read
    d_, f, E, a = OLMOE.d_model, OLMOE.d_ff, OLMOE.n_experts, 32 * 8
    least = 0.0
    for k_in, n_out in ((d_, f), (d_, f), (f, d_)):
        least += max(2.0 * a * k_in * n_out / roofline.PEAK_BF16,
                     2.0 * (a * k_in + E * k_in * n_out + a * n_out)
                     / roofline.HBM_BW)
    want = 100.0 * 4 * OLMOE.n_layers * least / secs
    assert metric_reader("grouped_zero_stall_matmul_roofline.decode")(run) \
        == pytest.approx(want)
    assert len(regions.expert_banks(OLMOE, 32)) == 3 * OLMOE.n_layers


def _admit(t, dur, decoding=None, name="serve.admit"):
    s = {"type": "span", "name": name, "t": t, "dur_s": dur, "rid": 1}
    if decoding is not None:
        s["decoding"] = decoding
    return s


def test_admit_stall_pct_is_the_held_share_of_the_window():
    spans = [_admit(1.0, 0.5, 0), _admit(2.0, 0.25, 3),
             _admit(3.0, 0.5, 1, "serve.prefill_chunk"),
             _admit(20.0, 1.0, 4)]                 # past the window
    run = _run([], others=spans, window=(0.0, 10.0), held_s=2.5,
               trace_window=None)
    assert metric_reader("admit_stall_pct")(run) == \
        pytest.approx(100.0 * 0.75 / 7.5)


def test_admit_stall_pct_leaves_the_profiled_slice_out():
    """Spans that overlap the profiled slice [5, 7) are not read, and the
    slice's seconds leave the window with those the profiler held."""
    spans = [_admit(2.0, 0.25, 3),
             _admit(4.9, 0.2, 2),                  # into the slice
             _admit(5.5, 0.5, 6),                  # inside it
             _admit(6.95, 0.1, 1),                 # out of it
             _admit(7.0, 0.5, 1, "serve.prefill_chunk")]
    run = _run([], others=spans, window=(0.0, 10.0), held_s=1.5,
               trace_window=(5.0, 7.0))
    assert metric_reader("admit_stall_pct")(run) == \
        pytest.approx(100.0 * 0.75 / 6.5)
    # a slice as long as the window leaves nothing to read
    whole = _run([], others=spans, window=(0.0, 10.0), held_s=0.5,
                 trace_window=(0.0, 10.0))
    assert metric_reader("admit_stall_pct")(whole) is None


def test_none_where_nothing_matched():
    kernels = KERNELS
    parent = _run([_dispatch(1.0, kernels, variant=None)])   # no map
    short = _run([_dispatch(1.0, kernels[:2])], events=[_event()])
    untraced = _run([_dispatch(1.0, kernels)], events=[_event()],
                    trace_window=None)
    for run in (parent, short, untraced):
        assert regions.matched(run) == []
        for name in ("decode_attention_ms.decode", "decode_sample_ms.decode",
                     "grouped_zero_stall_matmul_roofline.decode"):
            assert metric_reader(name)(run) is None
    # admissions that name no decoding slots (a program without the
    # attribute), or no admission at all
    assert metric_reader("admit_stall_pct")(
        _run([], others=[_admit(1.0, 0.5)])) is None
    assert metric_reader("admit_stall_pct")(_run([])) is None


def test_region_breakdown_sums_the_matched_dispatches_by_region():
    spans = [_dispatch(1.0, KERNELS, k=4, dur=1.0 * MS),
             _dispatch(2.0, KERNELS, k=4, dur=3.0 * MS),
             _dispatch(3.0, KERNELS[:3], k=4, dur=9.0 * MS)]  # not matched
    bd = region_breakdown.breakdown(_run(spans, events=[_event()]), top=1)
    assert (bd["dispatches"], bd["matched"], bd["steps"]) == (3, 2, 8)
    # each event lasts dur / 2: 2 + 6 ms of events, five a dispatch
    assert bd["device_ms_per_step"] == pytest.approx(5 * 4.0 / 2 / 8)
    got = {r["region"]: r for r in bd["regions"]}
    assert bd["regions"][0]["region"] == "attention.core"
    assert got["attention.core"]["ms_per_step"] == pytest.approx(2 * 2.0 / 8)
    assert got["attention.core"]["share_pct"] == pytest.approx(40.0)
    assert got["attention.core"]["top"] == [
        ["direct_copy_kernel_cuda", pytest.approx(2.0 / 8)]]  # of a tie
    assert sum(r["share_pct"] for r in bd["regions"]) == pytest.approx(100)
    assert any("attention.core: 0.5000 ms a step, 40.00%" in ln
               for ln in region_breakdown.lines(bd))
    # nothing matched: no regions, and the lines say so
    none = region_breakdown.breakdown(_run(spans[2:], events=[_event()]))
    assert (none["matched"], none["device_ms_per_step"], none["regions"]) \
        == (0, None, [])
    assert "nothing to break down" in region_breakdown.lines(none)[-1]


def test_region_breakdown_runs_the_cell_as_run_py_does():
    """Without a CUDA device it stops where run.py does, with its code."""
    out = subprocess.run(
        [sys.executable, "perfbench/region_breakdown.py", "--workload",
         "olmoe.decode_heavy", "--seed", "3000000001", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr
    assert "no CUDA device" in out.stderr and "[regions]" not in out.stderr
