"""The port's execution plans (``repro_torch.plan``) against the JAX
package's ``repro.plan``.

``OpKey`` bucketing and strings, ``KernelConfig`` JSON, plan files moving
between the packages, the ``config`` vocabulary of every ``ops`` entry
point and of ``Ctx``, ``trace_model``'s OpKey set on seven reduced
configs against JAX's ``trace_model`` under ``Plan(backend="interpret")``,
and the engine and launcher under ``plan=``.  Both packages' tune caches
point at temporary files in every test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import KernelConfig as JKernelConfig
from repro.plan import OpKey as JOpKey
from repro.plan import Plan as JPlan
from repro.plan import trace_model as j_trace_model
from repro_torch import obs, tune
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Ctx, build_model
from repro_torch.plan import (KernelConfig, OpKey, Plan, as_plan,
                              config_backend, resolve, trace_model)
from repro_torch.serve import Request, ServeEngine
import torch_tune_cache  # noqa: F401 (pins torch's threads)

ARCHS = ("gemma-7b", "deepseek-coder-33b", "olmoe-1b-7b", "mamba2-130m",
         "zamba2-2.7b", "seamless-m4t-large-v2", "llava-next-34b")
_FIELDS = ("bm", "bn", "bk", "variant", "slots", "grid_order", "bq", "bkv",
           "quant", "out_dtype")


@pytest.fixture(autouse=True)
def tune_caches(tmp_path):
    """Both packages' tune caches on temporary files, the port's tuner
    call counter at 0."""
    jtune.set_cache(jtune.TuneCache(tmp_path / "jax_tune.json"))
    tune.set_cache(tune.TuneCache(tmp_path / "tune.json"))
    obs.reset_counters("tune.")
    yield
    jtune.set_cache(None)
    tune.set_cache(None)


def _fields(cfg) -> dict:
    return {f: getattr(cfg, f) for f in _FIELDS}


# ----------------------------------------------------------------------
# OpKey and KernelConfig against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("op,M,N,K,groups,dtype", [
    ("matmul", 4, 3072, 4096, 1, "bfloat16"),
    ("matmul", 1, 1, 1, 1, "float32"),
    ("matmul", 129, 24576, 3072, 1, "int8"),
    ("grouped_matmul", 20, 1024, 2048, 64, "bfloat16"),
    ("grouped_matmul", 3, 100, 7, 5, "int8"),
    ("attention", 96, 256, 160, 1, "bfloat16"),
    ("attention", 1, 80, 3040, 1, "float32"),
])
def test_opkey_matches_jax(op, M, N, K, groups, dtype):
    k = OpKey(op, M, N, K, groups=groups, dtype=dtype)
    jk = JOpKey(op, M, N, K, groups=groups, dtype=dtype)
    assert k.to_str() == jk.to_str()
    assert k.bucketed().to_str() == jk.bucketed().to_str()
    assert k.dtype_bytes == jk.dtype_bytes
    assert OpKey.from_str(jk.bucketed().to_str()) == k.bucketed()
    with pytest.raises(ValueError, match="op"):
        OpKey("conv", M, N, K)


@pytest.mark.parametrize("kw", [
    {"bm": 64, "bn": 128, "bk": 128, "bq": 128, "bkv": 128, "slots": 3},
    {"bm": 128, "bn": 64, "bk": 256, "bq": 128, "bkv": 128,
     "variant": "single"},
    {"bm": 128, "bn": 128, "bk": 128, "bq": 32, "bkv": 16,
     "grid_order": "jik", "quant": "int8", "out_dtype": "float32"},
    {"bm": 8, "bn": 64, "bk": 64, "bq": 64, "bkv": 64, "slots": 4},
])
def test_kernel_config_json_matches_jax(kw):
    cfg, jcfg = KernelConfig(**kw), JKernelConfig(**kw)
    assert cfg.to_json() == jcfg.to_json()
    assert _fields(KernelConfig.from_json(jcfg.to_json())) == _fields(jcfg)
    assert _fields(JKernelConfig.from_json(cfg.to_json())) == _fields(cfg)


def test_kernel_config_json_resolves_bk_by_dtype():
    """``bk=None`` is written as the k tile it resolves to where the dtype
    is known, as JSON null where it is not; both read back."""
    cfg = KernelConfig()
    assert cfg.to_json("bfloat16") == {"bq": 32, "bkv": 32}
    assert cfg.to_json("int8") == {"bk": 256, "bq": 32, "bkv": 32}
    assert cfg.to_json("float32")["bk"] == 64
    assert cfg.to_json() == {"bk": None, "bq": 32, "bkv": 32}
    assert KernelConfig.from_json(cfg.to_json()) == cfg
    assert KernelConfig.from_json({"backend": "jnp"}).backend == "torch"
    assert KernelConfig.from_json({"backend": "pallas"}).backend == "auto"
    assert KernelConfig.from_json({}).bk == 128     # the schema's default


# ----------------------------------------------------------------------
# plan files between the packages
# ----------------------------------------------------------------------
def _jax_plan(arch="gemma-7b"):
    jcfg = j_get_config(arch, reduced=True)
    jm = j_build_model(jcfg)
    return j_trace_model(
        jm, [{"tokens": ((1, 8), jnp.int32), "lengths": ((1,), jnp.int32)}],
        JCtx(plan=JPlan(backend="interpret", quant=None), dtype=jnp.float32),
        max_len=32, decode_batch=2)


def test_jax_plan_file_loads_in_the_port(tmp_path):
    jplan = _jax_plan()
    jplan.add(JOpKey("matmul", 4, 64, 64, dtype="int8"),
              JKernelConfig(bm=64, slots=3, grid_order="jik",
                            out_dtype="bfloat16"))
    jplan.save(tmp_path / "jax.plan.json")
    plan = Plan.load(tmp_path / "jax.plan.json")
    assert plan.backend == "auto"           # JAX's "interpret": the kernels
    assert plan.default == "auto"
    assert {k.to_str() for k in plan.entries} == \
        {k.to_str() for k in jplan.entries}
    for jk, jcfg in jplan.items():
        assert _fields(plan.lookup(OpKey.from_str(jk.to_str()))) == \
            _fields(jcfg)
    # and back: the port's file loads in the JAX package, entries equal
    plan.save(tmp_path / "port.plan.json")
    back = JPlan.load(tmp_path / "port.plan.json")
    for jk, jcfg in jplan.items():
        assert _fields(back.lookup(jk)) == _fields(jcfg)


def test_plan_save_load_round_trip(tmp_path):
    m = build_model(get_config("gemma-7b", reduced=True))
    plan = trace_model(m, [{"tokens": (1, 8)}], Ctx(plan="auto",
                                                    dtype=torch.float32),
                       max_len=32, decode_batch=2)
    plan.add(OpKey("attention", 8, 32, 8, dtype="float32"),
             KernelConfig(bq=16, bkv=8))
    plan.save(tmp_path / "p.json")
    again = Plan.load(tmp_path / "p.json")
    assert again.fingerprint() == plan.fingerprint()
    assert again.to_json() == plan.to_json()
    assert json.loads((tmp_path / "p.json").read_text())["schema"] == 1
    with pytest.raises(ValueError, match="schema"):
        Plan.from_json({"schema": 2})


# ----------------------------------------------------------------------
# the config vocabulary
# ----------------------------------------------------------------------
def test_as_plan_and_config_backend_vocabulary():
    assert as_plan(None).default == KernelConfig()
    assert as_plan("auto").default == "auto"
    assert as_plan("torch").backend == "torch"
    cfg = KernelConfig(bm=64, quant="int8")
    assert as_plan(cfg).default is cfg and as_plan(cfg).quant == "int8"
    assert as_plan((64, 128, 128)).default == KernelConfig(bm=64, bn=128,
                                                           bk=128)
    assert as_plan((16, 16)).default == KernelConfig(bq=16, bkv=16)
    plan = Plan()
    assert as_plan(plan) is plan
    for bad in ("pallas", object(), (1,)):
        with pytest.raises(ValueError):
            as_plan(bad)
    assert config_backend(None) == config_backend("auto") == "auto"
    assert config_backend(Plan(backend="torch")) == "torch"
    with pytest.raises(ValueError, match="bm, bn, bk"):
        config_backend((16, 16), "matmul")
    with pytest.raises(ValueError, match="bq, bkv"):
        config_backend((16, 16, 16), "attention")
    assert resolve(None, op="matmul", M=4, N=8, K=8,
                   dtype=torch.float32) == KernelConfig()
    assert resolve((32, 64, 64), op="matmul", M=4, N=8, K=8,
                   dtype=torch.float32).bm == 32


def test_ops_take_the_whole_config_vocabulary():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((5, 48)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((48, 40)), dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((1, 2, 12, 16)),
                     dtype=torch.float32)
    want = ops.matmul(a, b, config="torch")
    want_att = ops.attention(q, q, q, config="torch")
    plan = Plan()
    for config in (None, "auto", KernelConfig(bm=32), (32, 64, 64), plan,
                   Plan(default=None)):
        torch.testing.assert_close(ops.matmul(a, b, config=config), want,
                                   rtol=0, atol=0)
    for config in (None, "auto", (16, 16), plan):
        torch.testing.assert_close(ops.attention(q, q, q, config=config),
                                   want_att, rtol=0, atol=0)
    # the auto plan resolved and memoized both call sites
    assert {k.op for k in plan.entries} == {"matmul", "attention"}
    with pytest.raises(ValueError, match="config"):
        ops.matmul(a, b, config="pallas")


def test_ctx_auto_resolves_once_per_call_site_through_the_tuner():
    """Ctx(plan="auto") tunes each call site through repro_torch.tune on
    its first call and memoizes into its Plan: the second pass makes no
    tuner call; Ctx(plan=None) is the fixed default and never tunes."""
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, dtype=torch.float32, device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    ctx = Ctx(plan="auto", dtype=torch.float32)
    m.prefill_logits(params, batch, ctx)
    first = tune.calls()
    assert first > 0
    assert len(ctx.plan) > 0
    m.prefill_logits(params, batch, ctx)
    assert tune.calls() == first
    fixed = Ctx(plan=None, dtype=torch.float32)
    m.prefill_logits(params, batch, fixed)
    assert tune.calls() == first and len(fixed.plan) == 0
    assert fixed.plan.default == KernelConfig()


def test_tuner_refuses_a_cuda_graph_capture(monkeypatch):
    """A plan miss never resolves inside a CUDA-graph capture."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        Plan().resolve("matmul", 4, 64, 64, dtype=torch.bfloat16)
    hit = Plan(entries={OpKey("matmul", 4, 64, 64, dtype="bfloat16"):
                        KernelConfig(bm=32)})
    assert hit.resolve("matmul", 4, 64, 64, dtype=torch.bfloat16).bm == 32


# ----------------------------------------------------------------------
# trace_model against the JAX package
# ----------------------------------------------------------------------
def _batches(cfg, jax_side: bool):
    i32 = jnp.int32 if jax_side else torch.int32
    f32 = jnp.float32 if jax_side else torch.float32
    b = {"tokens": ((1, 8), i32), "lengths": ((1,), i32)}
    kw = {}
    if cfg.family == "encdec":
        b["frontend_embeds"] = ((1, 6, cfg.d_model), f32)
        kw = {"enc_len": 6}
    elif cfg.frontend:
        b["frontend_embeds"] = ((1, cfg.frontend_tokens, cfg.d_model), f32)
    return [b, dict(b, tokens=((1, 16), i32))], kw


@pytest.mark.parametrize("arch", ARCHS)
def test_trace_model_opkeys_match_jax(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jb, kw = _batches(jcfg, True)
    tb, _ = _batches(cfg, False)
    jplan = j_trace_model(j_build_model(jcfg), jb,
                          JCtx(plan=JPlan(backend="interpret"),
                               dtype=jnp.float32),
                          max_len=32, decode_batch=2, cache_kwargs=kw)
    plan = trace_model(build_model(cfg), tb,
                       Ctx(plan="auto", dtype=torch.float32), max_len=32,
                       decode_batch=2, cache_kwargs=kw)
    assert {k.to_str() for k in plan.entries} == \
        {k.to_str() for k in jplan.entries}


def test_trace_model_refuses_train_and_needs_max_len():
    """``"train"`` traces the forward of ``model.loss`` (targets default
    to the tokens, no max_len needed) and resolves the same OpKeys as
    the JAX package's train trace; prefill and decode need max_len."""
    jcfg, cfg = j_get_config("gemma-7b", reduced=True), \
        get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    ctx = Ctx(plan="auto", dtype=torch.float32)
    plan = trace_model(m, [{"tokens": (1, 8)}], ctx, modes=("train",))
    jplan = j_trace_model(
        j_build_model(jcfg), [{"tokens": (1, 8)}],
        JCtx(plan=JPlan(backend="interpret"), dtype=jnp.float32),
        modes=("train",))
    assert {k.to_str() for k in plan.entries} == \
        {k.to_str() for k in jplan.entries}
    with pytest.raises(ValueError, match="max_len"):
        trace_model(m, [{"tokens": (1, 8)}], ctx)
    # the trace leaves the caller's plan untouched
    assert len(ctx.plan) == 0


# ----------------------------------------------------------------------
# the engine and the launcher under a plan
# ----------------------------------------------------------------------
def _pair(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    m = build_model(cfg)
    return m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")


def _serve(m, params, ctx, plan=None, **kw):
    eng = ServeEngine(m, params, ctx, num_slots=2, max_len=32,
                      steps_per_dispatch=4, device="cpu", plan=plan, **kw)
    prompts = [list(np.random.default_rng(i).integers(0, 256, n))
               for i, n in enumerate((5, 11, 3))]
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=5)
                   for i, p in enumerate(prompts)])
    return eng, [res[i].tokens for i in range(3)]


@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b"])
def test_engine_under_plans_matches_the_plain_path(arch, tmp_path):
    m, params = _pair(arch)
    ctx = Ctx(plan="auto", dtype=torch.float32)
    _, want = _serve(m, params, Ctx(plan="torch", dtype=torch.float32))
    traced, got = _serve(m, params, ctx, plan="trace")
    assert got == want
    traced.plan.save(tmp_path / "p.json")
    loaded = Plan.load(tmp_path / "p.json")
    assert loaded.fingerprint() == traced.plan.fingerprint()
    for plan in (loaded, (32, 64, 64)):
        eng, got = _serve(m, params, ctx, plan=plan)
        assert got == want
    assert eng.plan.default == KernelConfig(bm=32, bn=64, bk=64)
    # first-prefill logits under the traced plan against the plain path
    batch = {"tokens": torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])}
    got = m.prefill_logits(params, batch, ctx.with_plan(loaded))
    want = m.prefill_logits(params, batch, Ctx(plan="torch",
                                               dtype=torch.float32))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_traced_engine_never_calls_the_tuner_after_construction():
    m, params = _pair("gemma-7b")
    ctx = Ctx(plan="auto", dtype=torch.float32)
    eng = ServeEngine(m, params, ctx, num_slots=2, max_len=32,
                      steps_per_dispatch=4, device="cpu", plan="trace")
    built = tune.calls()
    assert built > 0 and eng.plan is eng.ctx.plan
    assert eng.plan is not ctx.plan and len(ctx.plan) == 0
    eng.run([Request(rid=i, prompt=[1 + i] * n, max_new_tokens=4)
             for i, n in enumerate((3, 9, 17, 30 - 4))])
    assert tune.calls() == built


def test_launcher_plan_trace_then_plan_path(tmp_path, capsys):
    out = tmp_path / "p.json"
    launch_serve.main(["--device", "cpu", "--batch", "2", "--gen-len", "3",
                       "--plan", "trace", "--plan-out", str(out)])
    first = capsys.readouterr().out
    fp = Plan.load(out).fingerprint()
    assert f"fingerprint {fp}" in first
    launch_serve.main(["--device", "cpu", "--batch", "2", "--gen-len", "3",
                       "--plan", str(out)])
    assert f"fingerprint {fp}" in capsys.readouterr().out
