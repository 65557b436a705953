"""One run of one cell: set-up, the measured window, the output check and
the result line.

The system under test is the port's serving engine,
``repro_torch.serve.engine.ServeEngine`` over
``repro_torch.models.build_model`` at ``Ctx(plan="auto")`` (or the
configuration's quantised plan), built with the mix's ``engine`` object
as its arguments, and driven only through ``submit``, ``step`` and
``pop_results``.  The harness makes the
weights (:mod:`perfbench.weights`) and the requests
(:mod:`perfbench.traffic`) from the seed, warms up every prompt bucket
and decode variant the mix uses (set-up), starts the load and lets it
settle (the ramp, also set-up), then serves for the window, timing every
token as it reaches the harness (:mod:`perfbench.e2e`).  A traced run
also records the engine's spans over the window and the device trace
over a slice of it (:mod:`perfbench.devtrace`), and reports the per-layer
metrics in place of the end-to-end ones.  After the window the program's
state is freed and the plain reference (:mod:`perfbench.check`) judges a
seeded sample of the finished greedy requests.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import numpy as np

from perfbench import check, e2e, weights
from perfbench.spec import Cell, ModelSpec, metric_reader, model_spec
from perfbench.traffic import Traffic

__all__ = ["Run", "Load", "port_config", "engine_kwargs", "program_ctx",
           "serve", "drain", "warm_up", "step", "build", "run_cell",
           "FORBIDDEN"]

# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_WARM_RID = 1 << 40
_DRAIN_LIMIT_S = 60.0


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a per-layer metric reader reads: the model's sizes, the
    window, the harness's event log, the engine's spans over the window,
    and the device events of the traced slice."""
    spec: ModelSpec
    window: tuple
    log: e2e.Log
    spans: list
    device: list
    trace_window: tuple | None
    prompt_len: dict
    held_s: float = 0.0     # seconds of the window the profiler held the host


# the published activation names and the port's MLP of each
_MLP = {"silu": "swiglu", "swish": "swiglu"}
# ServeEngine arguments the harness gives itself, never a mix
_HARNESS_ARGS = {"self", "model", "params", "ctx", "seed", "device"}


def port_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file: its sizes and
    its MLP, embeddings and projection biases as the file states them.
    A setting the plain reference does not follow is refused, as is a
    registry entry whose widths differ from the file's."""
    from repro_torch.configs.base import ModelConfig, get_config
    s = model_spec(config)
    act = config.get("hidden_act", "silu")
    if act not in _MLP:
        raise ValueError(f"hidden_act {act!r}: the reference follows "
                         f"{sorted(_MLP)} only")
    for key in ("tie_word_embeddings", "attention_bias"):
        if config.get(key, False):
            raise ValueError(f"{key} true: the reference follows untied "
                             "embeddings and unbiased projections only")
    fields = dict(n_layers=s.n_layers, d_model=s.d_model, n_heads=s.n_heads,
                  n_kv_heads=s.n_kv_heads, head_dim=s.head_dim, d_ff=s.d_ff,
                  vocab_size=s.vocab, norm_eps=s.norm_eps,
                  rope_theta=s.rope_theta, mlp_type=_MLP[act],
                  tie_embeddings=False, qkv_bias=False)
    if s.family == "moe":
        if not s.norm_topk_prob:
            raise ValueError("the port always renormalises the top-k gates: "
                             "state it as port.norm_topk_prob true, and the "
                             "published value among the departures")
        fields.update(n_experts=s.n_experts,
                      experts_per_token=s.experts_per_token,
                      capacity_factor=s.capacity_factor)
    if "registry" in config:
        reg = get_config(config["registry"])
        for k in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                  "n_experts", "experts_per_token", "mlp_type",
                  "tie_embeddings", "qkv_bias"):
            if k in fields and getattr(reg, k) != fields[k]:
                raise ValueError(f"{config['registry']}: the registry's "
                                 f"{k}={getattr(reg, k)!r} differs from the "
                                 f"file's {fields[k]!r}")
        if reg.resolved_head_dim != s.head_dim:
            raise ValueError(f"{config['registry']}: head_dim differs")
    return ModelConfig(name=s.name, family=s.family, **fields)


def _dtype(name: str):
    import torch
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dt


def engine_kwargs(config: dict, mix: dict) -> dict:
    """The mix's ``engine`` object as ``ServeEngine``'s keyword arguments,
    whole: every key is an argument of ``ServeEngine`` under its own name
    (``num_slots``, ``page_size``, ``prefill_chunk``, ...), a dtype by its
    torch name; ``cache_dtype`` defaults to the configuration's
    ``dtype``.  A key that ``ServeEngine`` does not take, or that the
    harness sets itself, is refused, so a mix can never name a path that
    does not run."""
    import inspect
    from repro_torch.serve.engine import ServeEngine
    takes = set(inspect.signature(ServeEngine.__init__).parameters)
    kw = dict(mix["engine"])
    bad = sorted(set(kw) - (takes - _HARNESS_ARGS))
    if bad:
        raise ValueError(f"the mix's engine names {bad}, which ServeEngine "
                         f"does not take from a mix; it takes "
                         f"{sorted(takes - _HARNESS_ARGS)}")
    kw["cache_dtype"] = _dtype(kw.get("cache_dtype", config["dtype"]))
    return kw


def program_ctx(config: dict):
    """The ``Ctx`` the configuration is served at: the configuration's
    ``dtype``, and ``port.quant`` (``null``, ``"int8"`` for W8A8 on the
    int8 kernels, or ``"fp8"``) as the plan's quantised mode."""
    from repro_torch.models import Ctx
    quant = config.get("port", {}).get("quant")
    if quant is None:
        plan = "auto"
    else:
        from repro_torch.plan import KernelConfig
        plan = KernelConfig(quant=quant)
    return Ctx(plan=plan, dtype=_dtype(config["dtype"]))


class Load:
    """The mix's requests as the loop offers them: a closed loop of
    ``clients`` (a client's next request falls due when its last one
    finishes), or an open loop whose requests fall due on the schedule."""

    def __init__(self, traffic: Traffic, eng, log: e2e.Log, t_start: float):
        from repro_torch.serve.request import Request
        self._Request = Request
        self.traffic, self.eng, self.log = traffic, eng, log
        self.closed = traffic.mix["loop"] == "closed"
        self.t_start = t_start
        self.next = 0
        self.stopped = False
        self.requests: dict[int, object] = {}      # rid -> traffic.Req
        if self.closed:
            for _ in range(traffic.mix["clients"]):
                self._submit(t_start, residual=True)

    def _submit(self, due: float, residual: bool = False) -> None:
        r = self.traffic.request(self.next, residual=residual)
        self.next += 1
        self.requests[r.rid] = r
        self.eng.submit(self._Request(
            rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
            temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
            seed=r.seed))
        self.log.due[r.rid] = due

    def next_due(self) -> float | None:
        if self.closed:
            return None
        return self.t_start + self.traffic.arrival(self.next)

    def submit_due(self, now: float) -> None:
        if self.closed or self.stopped:
            return
        while (t := self.next_due()) <= now:
            self._submit(t)

    def finished(self, t: float) -> None:
        if self.closed and not self.stopped:
            self._submit(t)


def serve(eng, load: Load, log: e2e.Log, until: float, *, hooks=(),
           need=()) -> None:
    """Serve until ``until`` and, past it, until every rid of ``need`` has
    its first token (at most ``_DRAIN_LIMIT_S`` more).  ``hooks`` are
    called with the time before every step."""
    clock = time.perf_counter
    need = set(need)
    while True:
        now = clock()
        for h in hooks:
            h(now)
        need -= log.first.keys()
        if now >= until and (not need or now >= until + _DRAIN_LIMIT_S):
            return
        load.submit_due(now)
        if eng.idle:
            nxt = load.next_due()
            end = until + (_DRAIN_LIMIT_S if need else 0.0)
            time.sleep(max(0.0, (end if nxt is None else min(nxt, end))
                           - now))
            continue
        step(eng, load, log)


def step(eng, load: Load, log: e2e.Log) -> None:
    """One engine step, its tokens logged at the step's return."""
    t0 = time.perf_counter()
    events = eng.step()
    t1 = time.perf_counter()
    for rid, tok in events:
        log.emit(rid, tok, t1)
    log.steps.append((t0, t1, len(events)))
    for rid, res in eng.pop_results().items():
        log.done[rid] = t1
        if list(res.tokens) != log.tokens.get(rid):
            raise RuntimeError(f"request {rid}: the result's tokens differ "
                               "from the streamed ones")
        load.finished(t1)


def drain(eng, load: Load, log: e2e.Log) -> None:
    """Stop offering requests and serve until the engine is idle."""
    load.stopped = True
    while not eng.idle:
        step(eng, load, log)


def warm_up(eng, traffic: Traffic, spec: ModelSpec, seed: int) -> None:
    """Admit one greedy and one sampled request at every prompt bucket the
    mix can use, each for two dispatches, so that every prefill program
    and both decode variants are built, captured and replayed once."""
    from repro_torch.serve.request import Request
    lo, hi = traffic.prompt_range()

    def bucket(n):
        return min(b for b in eng.bucket_sizes if b >= n)

    rng = np.random.default_rng([seed, 2])
    K = eng.steps_per_dispatch
    rid = _WARM_RID
    for b in sorted({bucket(lo), bucket(hi)}
                    | {b for b in eng.bucket_sizes
                       if bucket(lo) < b < bucket(hi)}):
        n = max(lo, min(b, hi))
        for temp in (0.0, 1.0):
            eng.submit(Request(rid=rid, prompt=tuple(
                int(t) for t in rng.integers(0, spec.vocab, n)),
                max_new_tokens=1 + 2 * K, temperature=temp, seed=rid))
            rid += 1
            while not eng.idle:
                eng.step()
    eng.pop_results()


def _setup_line(name: str, t0: float, extra: str = "",
                phases: dict | None = None) -> float:
    t = time.perf_counter()
    _log(f"setup.{name} {t - t0:.3f} s{extra}")
    if phases is not None:
        phases[name] = t - t0
    return t


def build(config: dict, mix: dict, seed: int, *, device: str = "cuda",
          phases: dict | None = None):
    """Set-up up to the load: the kernels built, the weights drawn from
    ``seed``, the engine, and every shape the mix uses warmed up.  Each
    phase's seconds are printed apart, and kept in ``phases`` where it is
    given -> (spec, engine, traffic, end)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    spec = model_spec(config)
    model = build_model(port_config(config))
    ctx, eng_kw = program_ctx(config), engine_kwargs(config, mix)
    t = time.perf_counter()
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
        t = _setup_line("build", t, phases=phases)
    params = weights.program_params(spec, seed, device, ctx.dtype)
    if ctx.plan.quant is not None:
        params = model.quantize_weights(params, fmt=ctx.plan.quant)
    if device == "cuda":
        torch.cuda.synchronize()
    t = _setup_line("weights", t, phases=phases)
    eng = ServeEngine(model, params, ctx, seed=seed, device=device, **eng_kw)
    t = _setup_line("engine", t, phases=phases)
    traffic = Traffic(mix, seed, spec.vocab)
    warm_up(eng, traffic, spec, seed)
    caps = eng.captures
    t = _setup_line("captures", t, f" ({len(caps)} graphs, "
                    f"{sum(c['capture_s'] for c in caps):.3f} s capturing, "
                    f"{sum(c['pool_bytes'] for c in caps)} pool bytes)",
                    phases)
    return spec, eng, traffic, t


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_process: float, device: str = "cuda", faults=None) -> dict:
    """One run of ``cell``: the result line's dict.  ``faults``, a
    callable given the engine before the load starts (tests only), breaks
    the timed path underneath."""
    import torch
    from repro_torch import obs

    mix = cell.traffic
    on_card = device == "cuda"
    # set-up's phases, printed apart and given on the result line: the
    # build's line shows the first run of a checkout, where nvcc runs
    phases = {"start": time.perf_counter() - t_process}
    _log(f"setup.start {phases['start']:.3f} s (interpreter, imports)")
    spec, eng, traffic, t = build(cell.config, mix, seed, device=device,
                                  phases=phases)
    if faults is not None:
        faults(eng)

    log = e2e.Log()
    load = Load(traffic, eng, log, t)
    ramp_end = t + float(mix["ramp_seconds"])
    serve(eng, load, log, ramp_end)
    w0 = time.perf_counter()
    setup_s = w0 - t_process
    _setup_line("ramp", t, phases=phases)
    _log(f"setup_s {setup_s:.3f} s")

    w1 = w0 + float(seconds)
    sink, dtrace, hooks, held = None, None, [], []
    if trace:
        sink = obs.ListSink()
        obs.enable(sink=sink)
        if on_card:
            from perfbench.devtrace import DeviceTrace
            dtrace = DeviceTrace()
            tr_len = min(float(mix["trace_seconds"]), float(seconds))
            tr0 = w0 + (float(seconds) - tr_len) / 2

            def profile(now):
                # the profiler's start and stop hold the host for seconds;
                # an open loop's schedule waits for them, so that the
                # slice reads the steady state and not a backlog they made
                if dtrace.window is None and not dtrace.running \
                        and now >= tr0:
                    dtrace.start()
                elif dtrace.running and now >= dtrace.t_begin + tr_len:
                    dtrace.stop()
                else:
                    return
                held.append(time.perf_counter() - now)
                load.t_start += held[-1]
                _log(f"profiler held the host {held[-1]:.3f} s")
            hooks.append(profile)
    serve(eng, load, log, w1, hooks=hooks)
    if trace:
        obs.disable()
        if dtrace is not None and dtrace.running:
            dtrace.stop()
    load.submit_due(w1)
    due = [r for r, d in log.due.items() if w0 <= d < w1]
    serve(eng, load, log, w1, need=due)
    t_end = time.perf_counter()
    _log(f"window {w1 - w0:.3f} s, drained {t_end - w1:.3f} s past it")
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    nums = e2e.end_to_end(log, w0, w1)

    metrics = {}
    if trace:
        run = Run(spec=spec, window=(w0, w1), log=log,
                  spans=sink.records, device=dtrace.events if dtrace else [],
                  trace_window=dtrace.window if dtrace else None,
                  prompt_len={r: len(q.prompt)
                              for r, q in load.requests.items()},
                  held_s=sum(held))
        for name in cell.per_layer:
            v = metric_reader(name)(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": cell.units[name]}
    else:
        e2e_names = {"out_tok_s", "tpot_p95_ms", "ttft_p95_ms"}
        for name in cell.end_to_end:
            if name == "setup_s":
                metrics[name] = {"value": setup_s, "unit": "s"}
            elif name in e2e_names and name in nums:
                metrics[name] = {"value": nums[name],
                                 "unit": cell.units[name]}
    _log("window numbers " + json.dumps(nums, sort_keys=True))

    sample = check.pick(log, load, mix["check"], seed, since=w0)
    first = check.pick_first(log, load, mix["check"], seed, since=w0)
    del eng, load
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.judge(spec, seed, sample, cell.config["check"],
                          device, first)
    out = {"correct": verdict["correct"], "attempted": nums["attempted"],
           "failed": nums["failed"], "metrics": metrics,
           "device": _device(torch, cell, peak, dtrace)}
    if dtrace is not None:
        out["breakdown"] = _breakdown(dtrace, sink.records, log)
    out["setup"] = phases
    out["checks"] = verdict["checks"]
    return out


def _device(torch, cell: Cell, peak: int, dtrace) -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": cell.chips, "memory_peak_bytes": int(peak)}
    if dtrace is not None:
        from perfbench.roofline import busy_union
        d["busy_s"] = busy_union((a, b) for _, a, b in dtrace.events)
        d["window_s"] = dtrace.window[1] - dtrace.window[0]
    return d


def _breakdown(dtrace, spans: list, log: e2e.Log) -> dict:
    """The ten device operations with the most time, and the ten longest
    idle gaps named by what the host was doing: inside an engine span
    (``serve.admit``, ``serve.dispatch``) or between engine steps."""
    by_name: dict[str, float] = {}
    for name, a, b in dtrace.events:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = dtrace.window
    gaps, end = [], lo
    for _, a, b in sorted(dtrace.events, key=lambda e: e[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    host = [(s["t"], s["t"] + s["dur_s"], s["name"]) for s in spans
            if s.get("type") == "span"]
    steps = [(a, b, "engine.step") for a, b, _ in log.steps]

    def what(a, b):
        mid = (a + b) / 2
        for s0, s1, name in host:
            if s0 <= mid <= s1:
                return name
        for s0, s1, name in steps:
            if s0 <= mid <= s1:
                return "engine.step outside the spans"
        return "host between engine steps"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[what(a, b), b - a] for a, b in longest]}


def forbidden_modules() -> list[str]:
    """The loaded top-level modules named in ``FORBIDDEN``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
