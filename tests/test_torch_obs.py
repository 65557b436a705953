"""The port's tracing core (``repro_torch.obs``) against ``repro.obs``.

The trace tests of ``tests/test_obs.py`` run on the port's copy: the
disabled span is one shared no-op, ``capture`` records and restores,
JSONL round-trips, ``enable`` refuses a sink and a path together, and
counters are always on and prefixed.  ``ops.fallback_counts`` reads the
``ops.fallback.`` counters.  A reduced engine emits the span and event
sequence of the JAX engine on the same requests (names and attributes;
times left out), contiguous and paged with chunked prefill: every record
and attribute the JAX engine emits, in its order.  The port's own spans
and attributes beside them (the ``serve.admit.*`` sub-spans,
``serve.schedule``, ``serve.drain``, ``decoding``, a dispatch's
``variant``) are held by ``tests/test_torch_regions.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import Ctx, build_model
from repro_torch.serve import Request, ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _reset_port_obs():
    """The port's tracer and counters are process-global: leave them
    clean around every test."""
    obs.disable()
    obs.reset_counters()
    ops.reset_fallback_warnings()
    yield
    obs.disable()
    obs.reset_counters()
    ops.reset_fallback_warnings()


def test_disabled_span_is_shared_noop():
    assert not obs.enabled()
    s1 = obs.span("a", x=1)
    s2 = obs.span("b")
    assert s1 is s2
    with s1:
        pass
    obs.event("dropped", v=3)     # no sink, no error


def test_capture_records_spans_and_events():
    with obs.capture() as sink:
        assert obs.enabled()
        with obs.span("work", step=3):
            pass
        obs.event("mark", rid=7)
    assert not obs.enabled()      # state restored
    assert [(r["type"], r["name"]) for r in sink.records] == [
        ("span", "work"), ("event", "mark")]
    assert sink.records[0]["step"] == 3 and sink.records[0]["dur_s"] >= 0.0
    assert sink.records[1]["rid"] == 7


def test_jsonl_sink_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "trace.jsonl")
    obs.enable(trace_path=path)
    try:
        with obs.span("outer", k=2):
            obs.event("inner", v=1.5)
    finally:
        obs.disable()
    lines = [json.loads(ln) for ln in open(path)]
    assert [r["name"] for r in lines] == ["inner", "outer"]  # exit order
    assert lines[0]["v"] == 1.5 and "dur_s" in lines[1]
    assert set(lines[1]) == {"type", "name", "t", "dur_s", "k"}


def test_enable_rejects_both_sink_and_path(tmp_path):
    with pytest.raises(ValueError, match="not both"):
        obs.enable(trace_path=os.path.join(tmp_path, "t.jsonl"),
                   sink=obs.ListSink())


def test_counters_always_on_and_prefixed():
    assert not obs.enabled()      # counters do not ride the switch
    obs.counter_inc("t.alpha")
    obs.counter_inc("t.alpha", 2)
    obs.counter_inc("t.beta")
    obs.counter_inc("other.gamma")
    assert obs.counters("t.") == {"t.alpha": 3, "t.beta": 1}
    obs.reset_counters("t.")
    assert obs.counters("t.") == {}
    assert obs.counters("other.") == {"other.gamma": 1}


def test_fallback_counts_queryable_and_reset(rng):
    assert ops.fallback_counts() == {}
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 16),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 12, 16),
                                             dtype=np.float32))
    with pytest.warns(RuntimeWarning, match="end-aligned"):
        ops.attention(q, k, k, causal=True)
    ops.attention(q, k, k, causal=True)   # counted again, warned once
    assert ops.fallback_counts() == {"attention_causal_unaligned": 2}
    assert obs.counters("ops.fallback.") == {
        "ops.fallback.attention_causal_unaligned": 2}
    ops.reset_fallback_warnings()
    assert ops.fallback_counts() == {} == obs.counters("ops.fallback.")
    with pytest.warns(RuntimeWarning, match="end-aligned"):
        ops.attention(q, k, k, causal=True)
    assert ops.fallback_counts() == {"attention_causal_unaligned": 1}


# ----------------------------------------------------------------------
# the engine's spans and events against the JAX engine's
# ----------------------------------------------------------------------
def _records(sink, keys: dict | None = None) -> list[dict]:
    """The records without their times; with ``keys`` (name -> the
    attributes kept), only the records so named, with those attributes."""
    return [{k: v for k, v in r.items() if k not in ("t", "dur_s")
             and (keys is None or k in keys[r["name"]])}
            for r in sink.records if keys is None or r["name"] in keys]


@pytest.mark.parametrize("mode", [
    {}, {"page_size": 4, "prefill_chunk": 4}], ids=["contiguous",
                                                    "paged+chunked"])
def test_engine_spans_and_events_equal_jax_engine(mode):
    jcfg = j_get_config("gemma-7b", reduced=True)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    m = build_model(get_config("gemma-7b", reduced=True))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), m.cfg,
                           device="cpu")
    prompts = [list(np.random.default_rng(i).integers(0, 256, n))
               for i, n in enumerate((5, 11, 3, 8, 6))]
    max_new = [6, 3, 1, 7, 4]            # rid 2 retires at admission
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=4, **mode)

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]

    with j_obs.capture() as j_sink:
        want = JServeEngine(jm, jp, JCtx(plan="jnp", dtype=jnp.float32),
                            **kw).run(reqs(JRequest))
    with obs.capture() as sink:
        got = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                          device="cpu", **kw).run(reqs(Request))
    assert {i: r.tokens for i, r in got.items()} == \
        {i: r.tokens for i, r in want.items()}
    # the JAX engine's names, each with every attribute it gives them
    keys: dict[str, set] = {}
    for r in j_sink.records:
        keys.setdefault(r["name"], set()).update(r)
    records = _records(sink, keys)
    assert records == _records(j_sink)
    names = {r["name"] for r in records}
    assert {"serve.admit", "serve.dispatch", "serve.retire"} <= names
    assert ("serve.prefill_chunk" in names) == ("prefill_chunk" in mode)
    assert all(r["type"] == "span" for r in sink.records
               if r["name"] != "serve.retire")
