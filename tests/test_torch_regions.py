"""The regions of the port's CUDA graphs and the engine's step spans.

``obs.region`` is the shared no-op outside a capture; a
``RegionRecorder`` driven by a faked capture labels every node with its
innermost region; the decode block, run eagerly under a recorder whose
"nodes" are the operators it dispatches, leaves no operator outside a
region and names the regions of the model step, the sampler and the
state, for a dense and an MoE model, contiguous and paged; the first
replay of each graph in a tracing session emits ``graphs.regions`` once,
and ``chip_smoke.py`` reads the graph and its outputs out of a capture's
tuple as ``graphs.replay`` does.
The engine's spans nest as named (``serve.admit.*`` inside
``serve.admit``, the admissions inside ``serve.schedule``, then
``serve.dispatch`` and ``serve.drain``, all inside each step's
``serve.step``), and an admission
carries the decoding slots it holds back.  On the card (``gpu``), a
reduced olmoe decode graph replayed under the profiler shows as many
device events as its map has nodes, and every zero-stall kernel falls
in an expert or a projection region.  No JAX here.
"""

import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import graphs, obs
from repro_torch.configs import get_config
from repro_torch.models import Ctx, build_model
from repro_torch.serve import Request, ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _reset_port_obs():
    obs.disable()
    yield
    obs.disable()


def _labels(regions: dict) -> list:
    """The region of each device node, from a map's runs."""
    out = []
    for name, first, end in regions["runs"]:
        assert first == len(out) and end > first
        out += [name] * (end - first)
    assert len(out) == regions["nodes"]
    return out


# ----------------------------------------------------------------------
# obs.region and the recorder
# ----------------------------------------------------------------------
def test_region_is_shared_noop_outside_a_capture():
    assert obs.region("a") is obs.region("b")
    with obs.capture() as sink:
        r = obs.region("attention.core")
        assert r is obs.region("moe.experts")
        with r:
            pass
    assert sink.records == []
    assert r is obs.span("off")          # the disabled span's no-op


class _FakeCapture:
    """A capture's chain of nodes: ``launch`` appends one; ``boundary``
    is what the driver's query gives, the last node captured."""

    def __init__(self):
        self.chain = []

    def launch(self, on_device=True):
        self.chain.append((f"n{len(self.chain)}", on_device))

    def boundary(self):
        return (self.chain[-1][0],) if self.chain else ()


def test_recorder_labels_every_node_with_its_innermost_region():
    cap = _FakeCapture()
    rec = obs.RegionRecorder(cap.boundary)
    with obs.recording(rec):
        cap.launch()                          # outside every region
        with obs.region("a"):
            cap.launch()
            with obs.region("b"):
                cap.launch()
                cap.launch(on_device=False)   # an event node: no position
                cap.launch()
            cap.launch()                      # back in a
            with obs.region("c"):             # captures nothing
                pass
            with obs.region("b"):
                cap.launch()
        cap.launch()
    assert obs.region("x") is obs.region("y")     # uninstalled again
    got = rec.runs(cap.chain)
    assert got == {"nodes": 7, "runs": [[None, 0, 1], ["a", 1, 2],
                                        ["b", 2, 4], ["a", 4, 5],
                                        ["b", 5, 6], [None, 6, 7]]}
    assert _labels(got) == [None, "a", "b", "b", "a", "b", None]


def test_recorder_takes_the_latest_of_joined_dependencies():
    chain = [("x", True), ("y", True), ("z", True)]
    marks = iter([("y", "x"), ("z",)])       # opens after a join of x, y
    rec = obs.RegionRecorder(lambda: next(marks))
    with obs.recording(rec):
        with obs.region("r"):
            pass
    assert rec.runs(chain) == {"nodes": 3, "runs": [[None, 0, 2],
                                                    ["r", 2, 3]]}


class _OpNodes(TorchDispatchMode):
    """Every operator dispatched is a node, as a kernel is in a graph."""

    def __init__(self):
        super().__init__()
        self.chain = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.chain.append((len(self.chain), True))
        return func(*args, **(kwargs or {}))

    def boundary(self):
        return (self.chain[-1][0],) if self.chain else ()


_DECODE = {"decode.model", "decode.sample", "decode.state", "model.embed",
           "model.norm", "model.head", "attention.qkv",
           "attention.cache_write", "attention.core", "attention.out"}


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch,mlp", [
    ("gemma-7b", {"mlp"}),
    ("olmoe-1b-7b", {"moe.route", "moe.dispatch", "moe.experts",
                     "moe.combine"})], ids=["dense", "moe"])
@pytest.mark.parametrize("greedy_only", [True, False],
                         ids=["greedy", "sampled"])
def test_decode_block_leaves_no_operator_outside_a_region(arch, mlp, mode,
                                                          greedy_only):
    m = build_model(get_config(arch, reduced=True))
    params = m.init(seed=0, device="cpu")
    eng = ServeEngine(m, params, Ctx(plan="auto", dtype=torch.float32),
                      device="cpu", num_slots=2, max_len=32,
                      steps_per_dispatch=2, **mode)
    rng = np.random.default_rng(0)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
            0, 256, 5 + i)), max_new_tokens=8, temperature=0.0 if
            greedy_only else 0.9, seed=i))
    eng.step()                                # both admitted, one dispatch
    nodes = _OpNodes()
    rec = obs.RegionRecorder(nodes.boundary)
    with obs.recording(rec), nodes:
        eng._block(greedy_only)
    labels = _labels(rec.runs(nodes.chain))
    assert len(labels) == len(nodes.chain) > 0
    assert None not in labels
    assert set(labels) == _DECODE | mlp


# ----------------------------------------------------------------------
# graphs.regions: once a graph a tracing session
# ----------------------------------------------------------------------
class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _captured(variant):
    record = {"variant": variant, "pool_bytes": 0, "capture_s": 0.0,
              "nodes": 3, "runs": [["decode.model", 0, 2],
                                   ["decode.state", 2, 3]]}
    return _FakeGraph(), f"out:{variant}", {}, record


def _region_events(sink):
    return [(r["variant"], r["nodes"], r["runs"]) for r in sink.records
            if r["name"] == "graphs.regions"]


def test_graphs_regions_emitted_once_a_graph_a_session():
    a, b = _captured("sampled"), _captured("greedy")
    assert graphs.replay(a) == "out:sampled"        # tracing off: nothing
    with obs.capture() as sink:
        for _ in range(3):
            graphs.replay(a)
        graphs.replay(b)
        graphs.replay(a)
    runs = [["decode.model", 0, 2], ["decode.state", 2, 3]]
    assert _region_events(sink) == [("sampled", 3, runs),
                                    ("greedy", 3, runs)]
    assert all(r["type"] == "event" for r in sink.records)
    graphs.replay(a)                                 # off again
    with obs.capture() as sink2:                     # a new session
        graphs.replay(b)
        with obs.capture() as inner:                 # and one inside it
            graphs.replay(b)
        graphs.replay(b)                             # the outer's again
    assert _region_events(sink2) == [("greedy", 3, runs)]
    assert _region_events(inner) == [("greedy", 3, runs)]
    assert a[0].replays == 6 and b[0].replays == 4
    assert not obs.first_in_session(a[3])            # tracing off


def test_chip_smoke_prefill_passes_read_a_captures_tuple():
    """chip_smoke.py's prefill passes take the graph and the logits out
    of the tuple :func:`graphs.capture` returns (graph, outputs, launch
    counts, record), as :func:`graphs.replay` does."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    logits = torch.arange(4.0)
    graph = _FakeGraph()

    class _Eng:
        def _load_prefill(self, req):
            return ("key", len(req.prompt))

        def _prefill_program(self, key):
            return logits + 1, None

    eng = _Eng()
    eng._pf_graphs = {("key", 8): (graph, (logits, None), {},
                                   {"variant": "prefill"})}
    req = types.SimpleNamespace(prompt=[1] * 8)
    fns = chip_smoke.prefill_passes(eng, [req], 8)
    _, got = fns["graph"]()
    assert graph.replays == 1 and got.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert fns["eager"]().tolist() == [1.0, 2.0, 3.0, 4.0]


# ----------------------------------------------------------------------
# the engine's step spans
# ----------------------------------------------------------------------
def _inside(inner, outer) -> bool:
    return (outer["t"] <= inner["t"]
            and inner["t"] + inner["dur_s"] <= outer["t"] + outer["dur_s"])


@pytest.mark.parametrize("mode", [
    {}, {"page_size": 4, "prefill_chunk": 4}], ids=["contiguous",
                                                    "paged+chunked"])
def test_engine_step_spans_nest_as_named(mode):
    m = build_model(get_config("gemma-7b", reduced=True))
    params = m.init(seed=0, device="cpu")
    eng = ServeEngine(m, params, Ctx(plan="auto", dtype=torch.float32),
                      device="cpu", num_slots=2, max_len=32,
                      steps_per_dispatch=4, **mode)
    prompts = [list(np.random.default_rng(i).integers(0, 256, n))
               for i, n in enumerate((5, 11, 3, 8, 6))]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, [6, 3, 1, 7, 4]))]
    with obs.capture() as sink:
        eng.run(reqs)
    spans = [r for r in sink.records if r["type"] == "span"]
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    subs = ("serve.admit.load", "serve.admit.prefill", "serve.admit.install",
            "serve.admit.first_token")
    assert set(by) >= {"serve.step", "serve.admit", "serve.schedule",
                       "serve.dispatch", "serve.drain", *subs}
    chunked = "prefill_chunk" in mode
    assert ("serve.prefill_chunk" in by) == chunked
    # each admission's four sub-spans lie inside it, in order, with its rid
    for adm in by["serve.admit"]:
        mine = [s for s in spans if s["name"] in subs
                and s["rid"] == adm["rid"]]
        assert [s["name"] for s in sorted(mine, key=lambda s: s["t"])] \
            == list(subs)
        assert all(_inside(s, adm) for s in mine)
    # a chunked admission installs and samples its first token after its
    # last chunk, under the same sub-span names
    admitted = {s["rid"] for s in by["serve.admit"]}
    for name in ("serve.admit.install", "serve.admit.first_token"):
        assert {s["rid"] for s in by[name]} == (
            {r.rid for r in reqs} if chunked else admitted)
    # decoding: the live slots held back, none at the first admission
    held = by["serve.admit"] + by.get("serve.prefill_chunk", [])
    first = min(held, key=lambda s: s["t"])
    assert first["decoding"] == 0
    assert all(0 <= s["decoding"] < 2 for s in held)
    assert any(s["decoding"] > 0 for s in held)
    # each step's schedule holds its chunks and admissions; a dispatching
    # step's schedule ends before its dispatch, whose drain follows
    for sch in by["serve.schedule"]:
        assert all(_inside(s, sch) for s in held if s["step"] == sch["step"])
    for d in by["serve.dispatch"]:
        assert d["variant"] == "greedy"
        sch, = [s for s in by["serve.schedule"] if s["step"] == d["step"]]
        dr, = [s for s in by["serve.drain"] if s["step"] == d["step"]]
        assert sch["t"] + sch["dur_s"] <= d["t"]
        assert d["t"] + d["dur_s"] <= dr["t"]
    assert len(by["serve.drain"]) == len(by["serve.dispatch"])
    assert len(by["serve.schedule"]) == eng._step
    # serve.step holds each step's spans, and is recorded after them
    assert [s["step"] for s in by["serve.step"]] == list(
        range(1, eng._step + 1))
    for st in by["serve.step"]:
        mine = [s for s in spans if s.get("step") == st["step"]
                and s["name"] != "serve.step"]
        assert mine and all(_inside(s, st) for s in mine)
        assert all(spans.index(s) < spans.index(st) for s in mine)


# ----------------------------------------------------------------------
# on the card (skips here)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: only the card captures graphs")
    return torch.device("cuda")


# the zero-stall products' kernels, as the benchmark names them
_ZERO_STALL = re.compile(r"\bsm90_kernel<|\bsplitk_reduce<|\bring_kernel<")
_PROJECTIONS = {"moe.experts", "attention.qkv", "attention.out",
                "model.head"}


@pytest.mark.gpu
def test_olmoe_decode_graph_map_matches_the_profiler(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("olmoe-1b-7b", reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, dtype=torch.bfloat16, device=cuda)
    eng = ServeEngine(m, params, Ctx(plan="auto", dtype=torch.bfloat16),
                      device="cuda", num_slots=4, max_len=64,
                      steps_per_dispatch=2, seed=3)
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
            0, cfg.vocab_size, 6 + i)), max_new_tokens=12, temperature=0.9,
            seed=i))
    while eng.stats.dispatches < 3:              # eager, capture, replay
        eng.step()
    record, = [c for c in eng.captures if c["variant"] == "sampled"]
    labels = _labels(record)
    assert None not in labels
    assert {"moe.experts", "attention.core", "decode.sample"} <= set(labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphs.replay(eng._graphs[False])
        torch.cuda.synchronize()
    events = sorted((e.start_ns(), e.name()) for e in
                    prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    names = [n for _, n in events]
    assert len(names) == record["nodes"], (
        f"{len(names)} device events against {record['nodes']} nodes; "
        f"first {names[:6]}, last {names[-6:]}")
    zs = [(n, lab) for n, lab in zip(names, labels) if _ZERO_STALL.search(n)]
    assert zs, "no zero-stall kernel in the decode graph"
    assert all(lab in _PROJECTIONS for _, lab in zs), zs
    assert any(lab == "moe.experts" for _, lab in zs)
