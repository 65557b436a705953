"""The port's static analyzer (``repro_torch.analyze``) against the JAX package's.

* Schedule hazards and plan lint: ``check_config`` and ``lint_plan`` on
  the same configs (JAX ``KernelConfig``s converted through the plan
  schema, ``KernelConfig.from_json``) give the same (rule, severity)
  sets as JAX's over a grid of ring depths 1-4, variants, stand-in
  mutants and the reduced gemma-7b / olmoe-1b-7b decode and prefill
  OpKeys of JAX's own trace, for every rule but ``ZS-S004`` and
  ``ZS-L003``; those two are held on constructed inputs to the Hopper
  numbers (a block's shared memory against ``HopperParams
  .smem_per_block`` and the tuner's staging share; the Hopper
  alignment).
* The Snitch cluster model and ``RULES`` equal JAX's exactly.
* Program lint: each P rule fires on a constructed case and only there;
  ``analyze_families`` comes out clean at ``fail_on="warning"`` on the
  meta device, the allowlist audit included.
* Kernel launch verification: every family sweeps clean over the
  tuning space, the geometry a wrapper launches from is the one it
  records, and JAX's three mutations (a k-outer walk, a single-slot
  overlap, an output over a live input) are flagged K004, K002, K005.
* The engine: ``validate=True`` accepts a traced plan (contiguous and
  paged) and refuses an int8-accumulating one naming ZS-L004;
  ``launch.serve --validate-plan`` runs on the CPU.
"""

import ast
import dataclasses
import functools
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analyze import check_config as j_check_config
from repro.analyze import lint_plan as j_lint_plan
from repro.configs import get_config as j_get_config
from repro.core import cyclemodel as j_cyclemodel
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import KernelConfig as JKernelConfig
from repro.plan import OpKey as JOpKey
from repro.plan import Plan as JPlan
from repro.plan import trace_model as j_trace_model
from repro_torch.analyze import (DEFAULT_ALLOW, RULES, analyze_families,
                                 check_allowlist, check_config, check_paged,
                                 lint_cluster, lint_kernel_ir, lint_kernels,
                                 lint_page_geometry, lint_plan, lint_program,
                                 trace_kernel_irs)
from repro_torch.configs import get_config
from repro_torch.core import cyclemodel
from repro_torch.core.cyclemodel import HopperParams
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import zero_stall_matmul as zs
from repro_torch.kernels.meta import (contract_for, kernel_name,
                                      registered_families)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Ctx, build_model
from repro_torch.models import layers as L
from repro_torch.plan import KernelConfig, OpKey, Plan
from repro_torch.serve import ServeEngine
from repro_torch.tune.space import DEFAULT_SPACE, SMALL_SPACE, Problem
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

META = torch.device("meta")
BUDGET = HopperParams().smem_per_block
# the rules whose numbers are Hopper's, not the TPU's
HOPPER_RULES = ("ZS-S004", "ZS-L003")


def _rules(diags, skip=HOPPER_RULES):
    return {(d.rule, d.severity) for d in diags if d.rule not in skip}


def _port_cfg(jcfg: JKernelConfig) -> KernelConfig:
    return KernelConfig.from_json(jcfg.to_json())


def _port_key(jkey: JOpKey) -> OpKey:
    return OpKey.from_str(jkey.to_str())


# ----------------------------------------------------------------------
# catalog and the Snitch model
# ----------------------------------------------------------------------
def test_rules_are_jax_rules():
    src = Path("src/repro/analyze/__init__.py").read_text()
    jrules = ast.literal_eval(src[src.index("RULES = {") + 8:])
    assert set(RULES) == set(jrules)
    for rule, (sev, layer, _) in RULES.items():
        assert layer == jrules[rule][1], rule
        # ZS-S004 has one threshold on Hopper, a block's shared memory
        assert sev == ("error" if rule == "ZS-S004" else jrules[rule][0]), \
            rule


def test_snitch_model_equals_jax():
    assert cyclemodel.SNITCH_CONFIGS.keys() == \
        j_cyclemodel.SNITCH_CONFIGS.keys()
    for name, c in cyclemodel.SNITCH_CONFIGS.items():
        jc = j_cyclemodel.SNITCH_CONFIGS[name]
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert c.conflict_free == jc.conflict_free
        model = cyclemodel.SnitchClusterModel(c)
        jmodel = j_cyclemodel.SnitchClusterModel(jc)
        for M, N, K in ((32, 32, 32), (48, 40, 72), (7, 100, 3)):
            for dma in (True, False):
                got = model.matmul(M, N, K, include_dma=dma)
                want = jmodel.matmul(M, N, K, include_dma=dma)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.utilization == want.utilization
                assert got.energy_eff_gflops_w == want.energy_eff_gflops_w
        nest = model.loopnest_for_block(4, 32, 16)
        jnest = jmodel.loopnest_for_block(4, 32, 16)
        assert nest.unrolled_trace() == jnest.unrolled_trace()


def test_kernel_families_register_jax_names():
    assert set(registered_families()) >= {
        "zero_stall_matmul", "grouped_zero_stall_matmul",
        "quantized_zero_stall_matmul", "quantized_grouped_zero_stall_matmul",
        "flash_attention", "paged_attention"}
    for fam in ("zero_stall_matmul", "grouped_zero_stall_matmul",
                "quantized_zero_stall_matmul",
                "quantized_grouped_zero_stall_matmul"):
        c = contract_for(kernel_name(fam, slots=3))
        assert c.managed_dma and c.slots == 3 and c.grid_rank == 2
    for fam in ("flash_attention", "paged_attention"):
        assert not contract_for(fam).managed_dma
    assert contract_for("zero_stall_matmul_s2_jik").grid_order == "jik"
    assert contract_for("cublas_gemm") is None


# ----------------------------------------------------------------------
# schedule hazards and plan lint against JAX
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_keys():
    """Decode and prefill OpKeys of JAX's own trace of reduced gemma-7b
    and olmoe-1b-7b (the interpret backend: real tiled configs)."""
    keys = set()
    for arch in ("gemma-7b", "olmoe-1b-7b"):
        jm = j_build_model(j_get_config(arch, reduced=True))
        plan = j_trace_model(
            jm, [{"tokens": (1, 16), "lengths": (1,)}],
            JCtx(plan=JPlan(backend="interpret"), dtype=jnp.float32),
            max_len=32, decode_batch=4)
        keys |= {k for k in plan.entries if k.op != "attention"}
    return sorted(keys)


def _grid():
    """JAX configs over ring depths 1-4 and both variants."""
    for bm, bn, bk in ((8, 8, 8), (16, 32, 16), (32, 16, 64)):
        yield JKernelConfig(bm=bm, bn=bn, bk=bk, variant="single", slots=1)
        for slots in (2, 3, 4):
            yield JKernelConfig(bm=bm, bn=bn, bk=bk, variant="dobu",
                                slots=slots)


def test_check_config_matches_jax_rule_sets():
    keys = _jax_keys()
    assert len(keys) >= 6
    checked = 0
    for jcfg in _grid():
        cfg = _port_cfg(jcfg)
        assert _rules(check_config(cfg)) == _rules(j_check_config(jcfg))
        for jkey in keys:
            assert _rules(check_config(cfg, _port_key(jkey))) == \
                _rules(j_check_config(jcfg, jkey)), (jcfg, jkey)
            checked += 1
    # duck-typed mutants the config class refuses to build
    for bad in (SimpleNamespace(bm=16, bn=16, bk=16, slots=1, variant="dobu"),
                SimpleNamespace(bm=16, bn=16, bk=16, slots=2,
                                variant="single"),
                SimpleNamespace(bm=8, bn=8, bk=8, resolved_slots=3)):
        assert _rules(check_config(bad)) == _rules(j_check_config(bad))
        for jkey in keys[:3]:
            assert _rules(check_config(bad, _port_key(jkey))) == \
                _rules(j_check_config(bad, jkey))
        assert ("ZS-S001", "error") in _rules(check_config(bad)) or \
            bad.variant != "dobu" if hasattr(bad, "variant") else True
    assert checked > 100


def _jplan_and_port(entries, **plan_kw):
    jplan = JPlan(**plan_kw)
    for k, c in entries:
        jplan.add(k, c)
    plan = Plan.from_json(jplan.to_json())
    return jplan, plan


def test_lint_plan_matches_jax_rule_sets():
    keys = _jax_keys()
    entries = [(k, c) for k, c in zip(keys, _grid())]
    entries += [
        (JOpKey("matmul", 64, 64, 64, dtype="int8"),
         JKernelConfig(bm=16, bn=16, bk=16, slots=2, out_dtype="int8")),
        (JOpKey("matmul", 64, 64, 64, dtype="float32"),
         JKernelConfig(bm=16, bn=16, bk=16, slots=2, out_dtype="int32")),
        (JOpKey("matmul", 32, 64, 64, dtype="float32"),
         JKernelConfig(bm=16, bn=16, bk=16, slots=2, out_dtype="bfloat16")),
        (JOpKey("matmul", 4, 64, 64, dtype="float32"),
         JKernelConfig(bm=8, bn=16, bk=16, variant="single", slots=1)),
        (JOpKey("matmul", 128, 64, 64, dtype="float32"),
         JKernelConfig(bm=16, bn=16, bk=16, slots=2, quant="int8")),
        (JOpKey("attention", 64, 16, 64, dtype="float32"),
         JKernelConfig(bq=16, bkv=16)),
    ]
    for kw in ({"backend": "interpret"}, {"backend": "interpret",
                                          "quant": "int8"}):
        jplan, plan = _jplan_and_port(entries, **kw)
        got, want = lint_plan(plan), j_lint_plan(jplan)
        assert _rules(got) == _rules(want)
        assert {"ZS-L004", "ZS-L005", "ZS-L006"} <= {d.rule for d in got}
    # per entry, not only as a union
    for k, c in entries:
        jplan, plan = _jplan_and_port([(k, c)], backend="interpret")
        assert _rules(lint_plan(plan)) == _rules(j_lint_plan(jplan)), k


@dataclasses.dataclass
class _Policy:
    """A stand-in retry policy (the rules are duck-typed)."""
    max_retries: int = 3
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 30.0
    restart_on_exhaustion: bool = True

    def total_delay_s(self) -> float:
        return sum(min(self.max_backoff_s,
                       self.backoff_base_s * self.backoff_factor ** i)
                   for i in range(self.max_retries))


def test_policy_and_cluster_rules_with_a_stand_in_policy():
    from repro.analyze import lint_cluster as j_lint_cluster
    from repro.runtime.fault_tolerance import RetryPolicy
    empty = Plan()
    for kw in ({}, {"max_retries": 0, "backoff_factor": 0.5},
               {"backoff_base_s": 1.0, "max_backoff_s": 0.5},
               {"restart_on_exhaustion": False}):
        mine, theirs = _Policy(**kw), RetryPolicy(**kw)
        assert _rules(lint_plan(empty, policy=mine)) == \
            _rules(j_lint_plan(JPlan(), policy=theirs))
    rules = {d.rule for d in lint_plan(empty, policy=_Policy(
        max_retries=0, backoff_factor=0.5))}
    assert {"ZS-F001", "ZS-F002", "ZS-F003"} <= rules
    a, b = Plan(), Plan(default=KernelConfig(bm=64))
    assert {d.rule for d in lint_cluster([a, a])} == set()
    assert {d.rule for d in lint_cluster([a, b])} == {"ZS-L009"}
    assert {d.rule for d in j_lint_cluster([JPlan(), JPlan(
        default=JKernelConfig(bm=64))])} == {"ZS-L009"}
    slow = _Policy(max_retries=5, backoff_base_s=0.5, max_backoff_s=8.0)
    assert {d.rule for d in lint_cluster([a], policy=slow,
                                         request_timeout_s=5.0)} == \
        {"ZS-F004"}
    assert len(lint_cluster([a], policy=slow, request_timeout_s=60.0)) == 0


# ----------------------------------------------------------------------
# the Hopper rules: ZS-S004 and ZS-L003 on constructed inputs
# ----------------------------------------------------------------------
def test_s004_holds_rings_to_a_blocks_shared_memory():
    key = OpKey("matmul", 128, 4096, 4096, dtype="bfloat16")
    # sm90 design: 1024 + slots * ((bn + rows) * bk * 2 + 16) bytes
    one = KernelConfig(bm=128, bn=128, bk=256, variant="single", slots=1)
    four = KernelConfig(bm=128, bn=128, bk=256, slots=4)
    fp1 = zs.sm90_smem_bytes(128, 128, 256, 1)
    assert BUDGET == zs.SMEM_LIMIT
    assert fp1 <= BUDGET < zs.sm90_smem_bytes(128, 128, 256, 4)
    assert not [d for d in check_config(one, key) if d.rule == "ZS-S004"]
    # one error threshold, a block's shared memory: no warning tier
    s004 = [(d.rule, d.severity) for d in check_config(four, key)
            if d.rule == "ZS-S004"]
    assert s004 == [("ZS-S004", "error")]
    # the tuner's legality is the same limit: the ring it drops is the
    # ring the analyzer refuses
    prob = Problem("matmul", 128, 4096, 4096, 2)
    legal = {(c.bm, c.bn, c.bk, c.slots)
             for c in DEFAULT_SPACE.candidates(prob)}
    assert (128, 128, 256, 1) in legal and (128, 128, 256, 4) not in legal
    # exactly at the budget is legal, a byte over is an error
    at = HopperParams(smem_per_block=fp1)
    assert not [d for d in check_config(one, key, params=at)
                if d.rule == "ZS-S004"]
    # a smaller budget (another card) moves the same ring to an error
    small = HopperParams(smem_per_block=fp1 - 1)
    assert ("ZS-S004", "error") in _rules(
        check_config(one, key, params=small), ())
    # the ring design (fp32): the cp.async ring's formula
    fkey = OpKey("matmul", 64, 64, 64, dtype="float32")
    fp = zs.smem_bytes(128, 128, 64, 4, torch.float32)
    assert (fp > BUDGET) == any(
        d.rule == "ZS-S004" and d.severity == "error" for d in check_config(
            KernelConfig(bm=128, bn=128, bk=64, slots=4), fkey))


def test_s004_flash_and_paged_footprints():
    ok = KernelConfig(bq=32, bkv=32)
    key = OpKey("attention", 128, 256, 128, dtype="bfloat16")
    assert check_config(ok, key) == []
    fkey = OpKey("attention", 256, 256, 256, dtype="float32")
    assert fa.smem_bytes(256, 64, 64, torch.float32) > BUDGET
    assert ("ZS-S004", "error") in _rules(
        check_config(KernelConfig(bq=64, bkv=64), fkey), ())
    assert check_paged(256, 16, 1, 2) == []
    assert pa.smem_bytes(256, 512, 1, 2, 2) > BUDGET
    assert {(d.rule, d.severity) for d in check_paged(256, 512, 1, 2)} == \
        {("ZS-S004", "error")}
    rep = lint_page_geometry(512, 1, max_len=512, head_dim=256, rep=1,
                             dtype_bytes=2,
                             plan=Plan(default=KernelConfig(bkv=512)))
    assert {d.rule for d in rep} == {"ZS-S004"}


def test_l003_uses_the_hopper_alignment():
    def l003(key, cfg, backend="auto"):
        plan = Plan(backend=backend)
        plan.add(key, cfg)
        return sorted(d.message.split("=")[0] for d in lint_plan(plan)
                      if d.rule == "ZS-L003")

    # bf16 (sm90): a bn of 128 over N = 64 and a bk of 128 over one
    # 64-element box are padding; bm = 128 at M = 4 runs 8 rows, no pad
    key = OpKey("matmul", 4, 64, 64, dtype="bfloat16")
    assert l003(key, KernelConfig(bm=128, bn=128, bk=128)) == ["bk", "bn"]
    assert l003(key, KernelConfig(bm=128, bn=64, bk=64)) == []
    # fp32 (the ring): bm is the tile, M pads to 8 rows
    fkey = OpKey("matmul", 4, 64, 32, dtype="float32")
    assert l003(fkey, KernelConfig(bm=32, bn=64, bk=32)) == ["bm"]
    assert l003(fkey, KernelConfig(bm=8, bn=64, bk=32)) == []
    # the plain backend pads nothing: every tile past its dim counts
    assert l003(key, KernelConfig(bm=128, bn=64, bk=64), "torch") == ["bm"]
    assert l003(key, KernelConfig(bm=4, bn=64, bk=64), "torch") == []


def test_page_geometry_rules():
    plan = Plan()
    plan.add(OpKey("attention", 64, 16, 64), KernelConfig(bq=16, bkv=16))
    assert len(lint_page_geometry(8, 4, max_len=32, plan=plan)) == 0
    assert {d.rule for d in lint_page_geometry(
        12, 4, max_len=32, plan=plan)} == {"ZS-L008"}
    assert {d.rule for d in lint_page_geometry(
        8, 2, max_len=32, plan=plan)} == {"ZS-S008"}


# ----------------------------------------------------------------------
# program lint
# ----------------------------------------------------------------------
def _prefill_lint(model, cfg, ctx, **kw):
    params = model.init(seed=0, dtype=torch.float32, device=META)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32, device=META),
             "lengths": torch.zeros((1,), dtype=torch.int32, device=META)}
    return lint_program(lambda: model.prefill(params, batch, ctx, 16), **kw)


def test_p001_flags_a_patched_fallback_and_nothing_else(monkeypatch):
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    ctx = Ctx(plan="auto", dtype=torch.float32)
    clean = _prefill_lint(model, cfg, ctx)
    assert clean.ok("warning"), clean.format()
    # the kernel backend issues no product on the meta device; the
    # plain backend's sit in sanctioned sites
    assert clean.meta["allow_hits"]["repro_torch/kernels/"] == 0
    plain = _prefill_lint(model, cfg, Ctx(plan="torch", dtype=torch.float32))
    assert plain.ok("warning") and \
        plain.meta["allow_hits"]["repro_torch/kernels/"] > 0

    def fallback_linear(p, x, mctx):
        return torch.matmul(x, p["w"].to(mctx.dtype))   # the silent one

    monkeypatch.setattr(L, "linear", fallback_linear)
    flagged = _prefill_lint(model, cfg, ctx)
    assert {d.rule for d in flagged} == {"ZS-P001"}
    assert all("test_torch_analyze.py" in d.where and
               "in fallback_linear" in d.where for d in flagged)
    # a cut above every product silences it
    assert len(_prefill_lint(model, cfg, ctx, min_flops=1e12)) == 0


def test_p002_flags_a_host_sync_inside_the_block():
    def block(x):
        y = x * 2.0
        if y.sum().item() > 0:           # a sync mid-block
            y = y + 1.0
        return y

    rep = lint_program(block, torch.ones(8))
    assert {(d.rule, d.severity) for d in rep} == {("ZS-P002", "error")}
    assert len(lint_program(lambda x: x * 2.0, torch.ones(8))) == 0
    # on the meta device the read is flagged, not crashed on
    assert {d.rule for d in lint_program(block, torch.ones(8,
                                                           device=META))} \
        == {"ZS-P002"}


def test_p003_flags_a_dequantize_then_matmul():
    def dequant_matmul(x, w8, scale):
        w = w8.to(torch.float32) * scale          # dequantized weights...
        return x @ w.t().t()                      # ...into an fp32 GEMM

    args = (torch.empty((16, 32), device=META),
            torch.empty((32, 16), dtype=torch.int8, device=META),
            torch.empty((1, 16), device=META))
    rules = {d.rule for d in lint_program(dequant_matmul, *args, quant=True)}
    assert rules == {"ZS-P003", "ZS-P001"}
    assert {d.rule for d in lint_program(dequant_matmul, *args)} == \
        {"ZS-P001"}
    # an fp32 product of fp32 weights is no upcast
    assert {d.rule for d in lint_program(
        lambda x, w: x @ w, args[0], torch.empty((32, 16), device=META),
        quant=True)} == {"ZS-P001"}


def test_p004_flags_a_stale_allowlist_entry():
    hits = {a: 1 for a in DEFAULT_ALLOW}
    assert len(check_allowlist(hits)) == 0
    stale = DEFAULT_ALLOW + ("in gone_function",)
    rep = check_allowlist(hits, allow=stale)
    assert [(d.rule, d.severity) for d in rep] == [("ZS-P004", "warning")]
    assert "gone_function" in rep.diagnostics[0].message


def test_analyze_families_clean_at_warning():
    reports = analyze_families()
    assert set(reports) == {"gemma-7b", "olmoe-1b-7b", "mamba2-130m",
                            "zamba2-2.7b", "seamless-m4t-large-v2",
                            "gemma-7b@torch", "allowlist"}
    for arch, rep in reports.items():
        assert rep.ok("warning"), (arch, rep.format())
    hits = reports["allowlist"].meta["allow_hits"]
    assert all(hits[a] > 0 for a in DEFAULT_ALLOW), hits
    assert reports["gemma-7b"].meta["programs_linted"] == 4
    assert reports["gemma-7b"].meta["plan_entries"] > 0


# ----------------------------------------------------------------------
# kernel launch verification
# ----------------------------------------------------------------------
def test_lint_kernels_sweeps_every_family_clean():
    rep = lint_kernels(space=SMALL_SPACE)
    assert rep.ok("warning"), rep.format()
    assert set(rep.meta["families"]) == {"zero_stall", "grouped",
                                         "quantized", "attention"}
    full = lint_kernels(space=DEFAULT_SPACE)
    assert full.ok("warning") and full.meta["zs_k_errors"] == 0
    assert full.meta["kernels_verified"] > 500


def test_wrappers_record_the_geometry_they_launch_from():
    """ops on the meta device records what launch_geometry gives, and
    that is the split plan and persistent walk the wrappers pass."""
    a = torch.empty((4, 3072), dtype=torch.bfloat16, device=META)
    b = torch.empty((3072, 4096), dtype=torch.bfloat16, device=META)
    cfg = KernelConfig(bm=128, bn=128, bk=128, slots=3, grid_order="jik")
    (ir,) = trace_kernel_irs(ops.matmul, a, b, config=cfg)
    assert ir.name == "zero_stall_matmul_s3_jik" and ir.design == "sm90"
    splits, per = zs.split_plan(4, 4096, 3072, 128, 128, 128, zs.H100_SMS)
    assert (ir.params["splits"], ir.params["per"]) == (splits, per)
    assert ir.grid == (32, splits) and ir.params["rows"] == 8
    g = gm.launch_geometry(64, 16, 1024, 2048, dtype=torch.bfloat16, sms=7)
    assert g.grid == (7, 1)
    walk = gm.grouped_walk(64, 16, 1024, 16, 128, 7)
    assert sum(len(w) for w in walk) == g.params["tiles"]
    p = pa.launch_geometry(4, 32, 128, 8, 30, 16, elt=2)
    assert (p.params["splits"], p.params["per"]) == pa.paged_splits(
        4, 8, 30, zs.H100_SMS)
    q = torch.empty((1, 4, 100, 64), dtype=torch.bfloat16, device=META)
    (f,) = trace_kernel_irs(ops.attention, q, q, q, config=(32, 32),
                            causal=True)
    assert f.grid == (4, 4) and f.design == "tensor_core"
    assert lint_kernel_ir(f).ok("warning")


def test_note_copies_lengths_at_record_time():
    """A recorded launch keeps its length tensors' values at the launch,
    not what the caller writes into them afterwards; with no recorder
    open nothing is built."""
    from repro_torch.kernels import meta as kmeta
    built = []

    def make():
        built.append(1)
        return fa.launch_geometry(2, 1, 64, 64, 64, dtype=torch.bfloat16,
                                  bq=32, bkv=32)

    kv = torch.tensor([64, 17], dtype=torch.int32)
    kmeta.note(make, lens={"kv_lens": kv})
    assert built == []
    with kmeta.record_launches() as got:
        kmeta.note(make, lens={"kv_lens": kv, "q_lens": None})
    kv.fill_(0)
    assert built == [1] and got[0].lens["q_lens"] is None
    assert got[0].lens["kv_lens"].tolist() == [64, 17]
    assert lint_kernel_ir(got[0]).ok("warning")


def _grouped_launch():
    return gm.launch_geometry(8, 32, 256, 512, dtype=torch.bfloat16, sms=5)


def test_k_outer_walk_flags_k004():
    good = _grouped_launch()
    assert good.grid[0] < good.params["tiles"]        # blocks walk tiles
    assert lint_kernel_ir(good).ok("warning")
    bad = good.replace(params={"k_inner": 0})
    rules = {d.rule for d in lint_kernel_ir(bad)}
    assert "ZS-K004" in rules


def test_single_slot_overlap_flags_k002():
    a = zs.launch_geometry(64, 512, 1024, dtype=torch.bfloat16, bm=64,
                           bn=128, bk=64, variant="single", slots=1, sms=4)
    assert a.params["per"] == 16                       # one split
    assert lint_kernel_ir(a).ok("warning")             # serialized: safe
    bad = a.replace(params={"lookahead": 1})           # overlap, 1 slot
    assert ("ZS-K002", "error") in _rules(lint_kernel_ir(bad).diagnostics,
                                          ())
    # look-ahead beyond the ring's depth is the same hazard
    deep = zs.launch_geometry(64, 512, 1024, dtype=torch.bfloat16, bm=64,
                              bn=128, bk=64, slots=3, sms=4)
    assert "ZS-K002" in {d.rule for d in lint_kernel_ir(
        deep.replace(params={"lookahead": 3}))}
    # a per-tile ring clock repeats a stage's mbarrier parity
    g = _grouped_launch().replace(params={"clock": "tile"})
    assert "ZS-K001" in {d.rule for d in lint_kernel_ir(
        g.replace(params={"steps": 3, "per": 3}))}


def test_output_over_a_live_input_flags_k005():
    a = zs.launch_geometry(4, 256, 512, dtype=torch.bfloat16)
    ins = (("in", "a", 0x1000, 0x1000 + 4 * 512 * 2),
           ("in", "b", 0x10000, 0x10000 + 512 * 256 * 2))
    clean = a.replace(buffers=ins + (("out", "c", 0x90000, 0x90800),))
    assert lint_kernel_ir(clean).ok("warning")
    alias = a.replace(buffers=ins + (("out", "c", 0x10400, 0x10c00),))
    assert {d.rule for d in lint_kernel_ir(alias)} == {"ZS-K005"}
    ws = a.replace(buffers=ins + (("out", "c", 0x90000, 0x90800),
                                  ("ws", "ws", 0x90400, 0x91000)))
    assert {d.rule for d in lint_kernel_ir(ws)} == {"ZS-K005"}


def test_attention_walk_coverage():
    f = fa.launch_geometry(2, 2, 80, 80, 64, dtype=torch.bfloat16, bq=32,
                           bkv=16)
    lens = {"q_lens": [80, 37], "kv_lens": [80, 37], "q_offsets": [0, 0]}
    assert lint_kernel_ir(f.replace(lens=lens)).ok("warning")
    # a grid that leaves q rows unwritten, a split order out of place
    assert "ZS-K004" in {d.rule for d in lint_kernel_ir(
        f.replace(grid=(2, 4)))}
    p = pa.launch_geometry(4, 8, 128, 2, 8, 16, elt=2, sms=16)
    assert (p.params["splits"], p.params["per"]) == (4, 2)
    kv = {"kv_lens": [15, 1, 128, 53]}
    assert lint_kernel_ir(p.replace(lens=kv)).ok("warning")
    short = p.replace(params={"per": 1}, lens=kv)      # pages never walked
    assert "ZS-K001" in {d.rule for d in lint_kernel_ir(short)}
    back = p.replace(params={"reduce_order": tuple(reversed(range(
        p.params["splits"])))})
    assert "ZS-K004" in {d.rule for d in lint_kernel_ir(back)}


# ----------------------------------------------------------------------
# the engine and the launcher
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _gemma():
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    return m, m.init(seed=0, device="cpu")


@pytest.mark.parametrize("mode", [{}, {"page_size": 8}],
                         ids=["contiguous", "paged"])
def test_engine_validate_accepts_a_traced_plan(mode, recwarn):
    m, p = _gemma()
    eng = ServeEngine(m, p, Ctx(plan="auto", dtype=torch.float32),
                      device="cpu", num_slots=2, max_len=32, plan="trace",
                      validate=True, **mode)
    assert len(eng.plan) > 0 and lint_plan(eng.plan).ok("warning")
    assert not [w for w in recwarn if "plan analysis" in str(w.message)]


def test_engine_validate_refuses_int8_accumulation():
    m, p = _gemma()
    bad = Plan(quant="int8")
    bad.add(OpKey("matmul", 64, 64, 64, dtype="int8").bucketed(),
            KernelConfig(bm=16, bn=16, bk=16, slots=2, out_dtype="int8"))
    ctx = Ctx(plan="auto", dtype=torch.float32)
    with pytest.raises(ValueError, match="ZS-L004"):
        ServeEngine(m, p, ctx, device="cpu", num_slots=2, max_len=16,
                    plan=bad, validate=True)
    # without the gate the same plan loads untouched, as in JAX
    assert ServeEngine(m, p, ctx, device="cpu", num_slots=2, max_len=16,
                       plan=bad).plan is bad
    with pytest.raises(ValueError, match="ZS-L008"):
        ServeEngine(m, p, ctx, device="cpu", num_slots=2, max_len=48,
                    page_size=12, validate=True)


def test_launch_serve_validate_plan_on_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--validate-plan", "--plan",
                       "trace", "--prompt-len", "8", "--gen-len", "4",
                       "--batch", "2", "--page-size", "4"])
    out = capsys.readouterr().out
    assert "generated shape: (2, 4)" in out
    got = launch_serve.serve_batch("gemma-7b", batch=2, prompt_len=8,
                                   gen_len=4, device="cpu",
                                   validate_plan=True, plan="trace")
    want = launch_serve.serve_batch("gemma-7b", batch=2, prompt_len=8,
                                    gen_len=4, device="cpu", plan="trace")
    np.testing.assert_array_equal(got["generated"], want["generated"])


# ----------------------------------------------------------------------
# on the card: the geometry recorded at real launches
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant,slots", [("single", 1), ("dobu", 3)])
def test_real_launches_record_their_geometry_clean(cuda, variant, slots):
    """Each of the six wrappers, launched on the card, records the
    launch it made (storage ranges included), and it lints clean."""
    from repro_torch.kernels import grouped_matmul as g
    from repro_torch.kernels import quantized_matmul as q
    from repro_torch.kernels.meta import record_launches

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)

    def bf(*shape):
        return torch.randn(*shape, device=cuda, generator=gen).to(
            torch.bfloat16)

    def i8(*shape):
        return torch.randint(-127, 128, shape, device=cuda, generator=gen,
                             dtype=torch.int8)

    ring = dict(variant=variant, slots=slots)
    with record_launches() as got:
        zs.zero_stall_matmul(bf(4, 512), bf(512, 256), **ring)
        zs.zero_stall_matmul(bf(24, 100), bf(100, 72), **ring)  # ring
        g.grouped_zero_stall_matmul(bf(4, 8, 256), bf(4, 256, 128), **ring)
        q.quantized_zero_stall_matmul(
            i8(4, 512), i8(256, 512).t(), torch.rand(4, 1, device=cuda),
            torch.rand(1, 256, device=cuda), **ring)
        q.quantized_grouped_zero_stall_matmul(
            i8(4, 8, 256), i8(4, 128, 256).mT,
            torch.rand(4, 8, 1, device=cuda),
            torch.rand(4, 1, 128, device=cuda), **ring)
        x = bf(1, 2, 64, 64)
        fa.flash_attention(x, bf(*x.shape), bf(*x.shape), bq=32, bkv=16)
        pool = bf(9, 16, 2, 64)
        table = torch.arange(1, 9, dtype=torch.int32,
                             device=cuda).reshape(2, 4)
        kv_lens = torch.tensor([50, 3], dtype=torch.int32, device=cuda)
        pa.paged_attention(bf(2, 4, 64), pool, bf(*pool.shape), table,
                           kv_lens=kv_lens)
    kv_lens.fill_(0)                # updated in place after the launch
    torch.cuda.synchronize()
    assert len(got) == 7
    # the record is the geometry of the module's launch_geometry
    sms = zs.sms_of(cuda)
    for ir, want in ((got[0], zs.launch_geometry(
            4, 256, 512, dtype=torch.bfloat16, sms=sms, **ring)),
            (got[2], g.launch_geometry(4, 8, 128, 256, dtype=torch.bfloat16,
                                       sms=sms, **ring)),
            (got[6], pa.launch_geometry(2, 4, 64, 2, 4, 16, elt=2,
                                        sms=sms))):
        assert (ir.name, ir.grid, dict(ir.params)) == \
            (want.name, want.grid, dict(want.params))
    assert got[6].lens["kv_lens"].tolist() == [50, 3]
    assert {ir.family for ir in got} == {
        "zero_stall_matmul", "grouped_zero_stall_matmul",
        "quantized_zero_stall_matmul", "quantized_grouped_zero_stall_matmul",
        "flash_attention", "paged_attention"}
    assert got[1].design == "ring" and got[0].design == "sm90"
    for ir in got:
        assert any(role == "out" for role, *_ in ir.buffers)
        rep = lint_kernel_ir(ir)
        assert rep.ok("warning"), rep.format()
