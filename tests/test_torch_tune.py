"""The port's core and tuner (``repro_torch.core``, ``repro_torch.tune``)
against the JAX package's, and the Hopper model against the card.

* ``RevolvingSchedule`` / ``DobuSchedule`` and ``LoopNest`` equal to
  JAX's over a grid of slots, steps and nests;
* ``exhaustive_search`` / ``hill_climb`` give JAX's winners under one
  deterministic toy oracle, on JAX's own space;
* ``TuneCache`` keys equal JAX's, merge on save, hits;
* the Hopper space (the wrappers' own legality, the default first) and
  the analytic tuner;
* the calibration of :class:`~repro_torch.core.HopperPipelineModel`
  against the port's measured tables (``PERF.md`` §6, and every
  candidate of the space measured at 25 main-path shapes,
  ``tests/data/h100_matmul_tables.csv``);
* ``MeasuredOracle`` on the CPU when named, refusing without a card
  otherwise, and on the card (``gpu`` marker).
"""

import csv
import importlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.core.loopnest import Loop as JLoop
from repro.core.loopnest import LoopNest as JLoopNest
from repro.core.loopnest import matmul_nest as j_matmul_nest
from repro.core.pipeline import DobuSchedule as JDobu
from repro.core.pipeline import RevolvingSchedule as JRevolving
from repro_torch import obs, tune
from repro_torch.core import (DobuSchedule, HopperParams,
                              HopperPipelineModel, Loop, LoopNest,
                              RevolvingSchedule, matmul_nest)
from repro_torch.kernels import zero_stall_matmul as zs
from repro_torch.plan import KernelConfig, OpKey, Plan
from repro_torch.tune import (DEFAULT_SPACE, SMALL_SPACE, AnalyticOracle,
                              Candidate, MeasuredOracle, Problem, TuneCache)
import torch_tune_cache  # noqa: F401 (pins torch's threads)


# the modules (the packages export functions of the same name)
jsearch = importlib.import_module("repro.tune.search")
tsearch = importlib.import_module("repro_torch.tune.search")


@pytest.fixture(autouse=True)
def tune_caches(tmp_path):
    jtune.set_cache(jtune.TuneCache(tmp_path / "jax_tune.json"))
    tune.set_cache(TuneCache(tmp_path / "tune.json"))
    obs.reset_counters("tune.")
    yield
    jtune.set_cache(None)
    tune.set_cache(None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# core: schedules and loop nests against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("slots", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("steps", [1, 2, 3, 5, 8, 13])
def test_revolving_schedule_matches_jax(slots, steps):
    s, j = RevolvingSchedule(steps, slots), JRevolving(steps, slots)
    assert s.timeline() == j.timeline()
    assert s.prologue_steps() == j.prologue_steps()
    assert [s.live_slots(t) for t in range(steps)] == \
        [j.live_slots(t) for t in range(steps)]
    assert s.conflict_free() == j.conflict_free()
    assert s.conflict_free() or slots == 1
    if slots >= 2:
        d, jd = DobuSchedule(steps, slots), JDobu(steps, slots)
        assert [tuple(vars(p).values()) for p in d.phases()] == \
            [tuple(vars(p).values()) for p in jd.phases()]
        assert d.conflict_free() and jd.conflict_free()


_NESTS = [
    ((3, 2, 4), 1), ((1, 1, 1), 2), ((2, 5, 3), 3), ((4, 1, 2), 4),
]


@pytest.mark.parametrize("trips,body", _NESTS)
def test_loopnest_traces_match_jax(trips, body):
    n, jn = matmul_nest(*trips, body=body), j_matmul_nest(*trips, body=body)
    assert n.unrolled_trace() == jn.unrolled_trace()
    assert n.sequencer_trace() == jn.sequencer_trace()
    assert n.total_issued == jn.total_issued
    for oh in (0, 2, 10):
        assert n.issue_cycles(zonl=False, outer_overhead=oh) == \
            jn.issue_cycles(zonl=False, outer_overhead=oh)
    assert n.as_pallas_grid() == jn.as_pallas_grid() == trips
    assert list(n.iter_space()) == list(jn.iter_space())


def test_imperfect_loopnest_matches_jax():
    spec = dict(num_insts=7)
    loops = [(3, 1, 5, "o"), (2, 2, 4, "i")]
    n = LoopNest(loops=tuple(Loop(*a) for a in loops), **spec)
    jn = JLoopNest(loops=tuple(JLoop(*a) for a in loops), **spec)
    assert n.unrolled_trace() == jn.unrolled_trace()
    assert n.sequencer_trace() == jn.sequencer_trace()
    assert n.overhead_fraction() == jn.overhead_fraction()


# ----------------------------------------------------------------------
# search strategies against the JAX package
# ----------------------------------------------------------------------
class _JaxSpaceWithCorners:
    """JAX's INTERPRET_SPACE with the port's ``corners`` hook: the seeds
    JAX's hill_climb scatters, computed JAX's way."""

    def __init__(self, space):
        self._s = space

    def __getattr__(self, name):
        return getattr(self._s, name)

    def corners(self, problem):
        s = self._s
        return [jtune.Candidate(t, t, t, sl, s.grid_orders[0])
                for t in (s.tile_options[0], s.tile_options[-1])
                for sl in (s.slot_options[0], s.slot_options[-1])
                if s.feasible(jtune.Candidate(t, t, t, sl,
                                              s.grid_orders[0]), problem)]


class _ToyOracle:
    """Deterministic, non-convex score of a candidate."""

    def estimate(self, c, p):
        return (abs(c.bm - 16) + 0.5 * abs(c.bn - 32) + 0.25 * c.bk
                + (3.0 if c.slots == 1 else 0.1 * c.slots)
                + (p.M % 7) * 0.01 * c.bm)


@pytest.mark.parametrize("M,N,K", [(8, 32, 16), (64, 64, 64), (20, 40, 24)])
def test_search_winners_match_jax(M, N, K):
    space = jtune.INTERPRET_SPACE
    p = jtune.Problem("matmul", M, N, K, dtype_bytes=2)
    oracle = _ToyOracle()
    want_ex = jsearch.exhaustive_search(space, oracle, p)
    want_hc = jsearch.hill_climb(space, oracle, p)
    got_ex = tsearch.exhaustive_search(space, oracle, p)
    got_hc = tsearch.hill_climb(_JaxSpaceWithCorners(space), oracle, p)
    assert (got_ex.best, got_ex.predicted_s, got_ex.evaluated) == \
        (want_ex.best, want_ex.predicted_s, want_ex.evaluated)
    assert (got_hc.best, got_hc.predicted_s, got_hc.evaluated) == \
        (want_hc.best, want_hc.predicted_s, want_hc.evaluated)
    assert tsearch.search(space, oracle, p).best == \
        jsearch.search(space, oracle, p).best


def test_hill_climb_reaches_the_exhaustive_winner_on_the_port_space():
    p = Problem("matmul", 128, 4096, 3072, dtype_bytes=2)
    oracle = AnalyticOracle()
    ex = tsearch.exhaustive_search(DEFAULT_SPACE, oracle, p)
    hc = tsearch.hill_climb(DEFAULT_SPACE, oracle, p)
    assert hc.predicted_s <= ex.predicted_s * 1.05
    assert hc.evaluated < ex.evaluated


# ----------------------------------------------------------------------
# cache
# ----------------------------------------------------------------------
@pytest.mark.parametrize("op,M,N,K,groups,dtype", [
    ("matmul", 4, 3072, 4096, 1, "bfloat16"),
    ("grouped_matmul", 20, 1024, 2048, 64, "int8"),
    ("attention", 128, 256, 128, 1, "bfloat16"),
])
def test_tune_cache_keys_match_jax(op, M, N, K, groups, dtype):
    eb = 1 if dtype == "int8" else 2
    key = TuneCache.key(Problem(op, M, N, K, eb, groups), backend="cuda",
                        dtype=dtype)
    jkey = jtune.TuneCache.key(jtune.Problem(op, M, N, K, eb, groups),
                               backend="cuda", dtype=dtype)
    assert key == jkey
    assert TuneCache.parse_key(key) == jtune.TuneCache.parse_key(jkey)
    assert tune.shape_bucket(Problem(op, M, N, K)) == \
        jtune.shape_bucket(jtune.Problem(op, M, N, K))


def test_tune_cache_merges_on_save_and_counts_hits(tmp_path):
    path = tmp_path / "c.json"
    a, b = TuneCache(path), TuneCache(path)
    a.put("matmul|4x64x64|bfloat16|cuda", Candidate(32, 64, 64))
    b.put("matmul|8x64x64|bfloat16|cuda", Candidate(64, 64, 128, 3))
    merged = TuneCache(path)
    assert len(merged) == 2
    assert merged.get("matmul|8x64x64|bfloat16|cuda") == \
        Candidate(64, 64, 128, 3)
    assert merged.get("matmul|16x64x64|bfloat16|cuda") is None
    assert (merged.hits, merged.misses) == (1, 1)
    path.write_text("{not json")
    assert len(TuneCache(path)) == 0
    assert tune.default_cache_path().name == "tune.json"
    assert "repro_torch" in str(tune.default_cache_path()) or \
        tune.default_cache_path() != jtune.default_cache_path()


def test_plan_and_tune_cache_convert_both_ways(tmp_path):
    cache = TuneCache(tmp_path / "c.json")
    c1 = tune.best_config("matmul", 128, 4096, 3072, dtype=torch.bfloat16,
                          cache=cache)
    bq, bkv = tune.best_attention_config(128, 128, 256,
                                         dtype=torch.bfloat16, cache=cache)
    plan = Plan.from_tune_cache(cache)
    assert plan.lookup(OpKey("matmul", 128, 4096, 3072,
                             dtype="bfloat16")) == \
        KernelConfig.from_candidate(c1)
    att = plan.lookup(OpKey("attention", 128, 256, 128, dtype="bfloat16"))
    assert (att.bq, att.bkv) == (bq, bkv)
    seeded = plan.seed_tune_cache(TuneCache(tmp_path / "d.json"))
    assert dict(seeded.items()) == dict(cache.items())
    cache.put("matmul|4x8x8|float32|other", Candidate(32, 64, 64))
    with pytest.raises(ValueError, match="multiple backends"):
        Plan.from_tune_cache(cache)
    assert len(Plan.from_tune_cache(cache, backend="other")) == 1


# ----------------------------------------------------------------------
# the Hopper space and the analytic tuner
# ----------------------------------------------------------------------
@pytest.mark.parametrize("M,N,K,eb,groups", [
    (4, 4096, 3072, 2, 1), (128, 24576, 3072, 2, 1), (4, 3072, 24576, 1, 1),
    (20, 1024, 2048, 2, 64), (1, 2048, 1024, 1, 64), (5, 40, 48, 4, 1),
    (4, 100, 30, 2, 1),
])
def test_space_is_what_the_wrappers_take(M, N, K, eb, groups):
    op = "grouped_matmul" if groups > 1 else "matmul"
    p = Problem(op, M, N, K, eb, groups)
    cands = list(DEFAULT_SPACE.candidates(p))
    dtype = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}[eb]
    d = KernelConfig()
    default = Candidate(d.bm, d.bn, d.resolved_bk(dtype), 2, "ijk")
    assert DEFAULT_SPACE.default(p) == default
    # the default comes first wherever it is legal (a k tile longer than
    # K rounded up to a box streams only padding, as at K = 30, and so
    # does a bn wider than N rounded up to 64, as at N = 40)
    assert (cands[0] == default) == DEFAULT_SPACE.feasible(default, p)
    assert (cands[0] == default) == (K != 30 and N > 64)
    assert len(cands) == len(set(cands)) == DEFAULT_SPACE.size(p)
    design = zs.select_design(dtype, K, N, False)
    for c in cands:
        if design == "sm90":
            zs._check_sm90_config(M, c.bm, c.bn, c.bk, c.slots, dtype)
            assert zs.sm90_smem_bytes(zs.sm90_rows(M, c.bm), c.bn, c.bk,
                                      c.slots, eb) <= zs.SMEM_LIMIT
        else:
            zs._check_config(c.bm, c.bn, c.bk, c.slots, dtype, False)
        assert c.bk * eb in (128, 256, 384, 512)
        if groups > 1:
            assert c.grid_order == "ijk"
    # sm90: a bm at or above the rows M fills is one launch, only 128
    # stays; the ring runs bm rows, so none past M's granule stays
    if design == "sm90":
        assert all(c.bm == 128 or c.bm < zs.sm90_rows(M, 128)
                   for c in cands)
    else:
        gran = 8 if eb == 4 else 32
        assert all(c.bm <= max(gran, -(-M // gran) * gran) for c in cands)
    assert SMALL_SPACE.size(p) < len(cands)


def test_attention_space_and_tuner():
    kw = dict(s_q=128, s_kv=128, head_dim=256, dtype_bytes=2)
    tiles = list(DEFAULT_SPACE.attention_candidates(**kw))
    assert tiles[0] == (32, 32)
    assert all(bkv * 256 <= 8192 for _, bkv in tiles)
    one_row = list(DEFAULT_SPACE.attention_candidates(
        s_q=1, s_kv=128, head_dim=64, dtype_bytes=2))
    assert one_row[0] == (16, 32) and all(bq == 16 for bq, _ in one_row)
    got = tune.best_attention_config(128, 128, 256, dtype=torch.bfloat16,
                                     batch_heads=16)
    assert got in tiles
    assert tune.calls() == 1


def test_analytic_tuner_is_cached_and_keeps_the_default_on_ties():
    cache = tune.get_cache()
    got = tune.best_config("matmul", 4, 4096, 3072, dtype=torch.bfloat16)
    assert (cache.hits, cache.misses) == (0, 1)
    assert tune.best_config("matmul", 4, 4096, 3072,
                            dtype=torch.bfloat16) == got
    assert cache.hits == 1
    p = Problem("matmul", 4, 4096, 3072, 2)
    oracle = AnalyticOracle()
    best = tsearch.search(DEFAULT_SPACE, oracle, p)
    default = DEFAULT_SPACE.default(p)
    if oracle.estimate(default, p) <= best.predicted_s * (1 + tune.MIN_GAIN):
        assert got == default
    else:
        assert got == best.best
    assert tune.calls() == 2


def test_analytic_oracle_prefers_a_ring_over_serial_copies():
    """The paper's claim on the model: at decode, where copies bound the
    product, a ring of two or more stages never loses to one stage."""
    oracle = AnalyticOracle()
    for M, N, K in ((4, 4096, 3072), (4, 3072, 24576), (4, 24576, 3072)):
        p = Problem("matmul", M, N, K, 2)
        single = oracle.estimate(Candidate(128, 128, 128, 1), p)
        for slots in (2, 3, 4):
            assert oracle.estimate(Candidate(128, 128, 128, slots),
                                   p) < single


# ----------------------------------------------------------------------
# calibration: the Hopper model against the port's chip tables
# ----------------------------------------------------------------------
# Measured on NVIDIA H100 80GB HBM3 at 700.00 W by chip_smoke.py phase 6
# (device time over a CUDA graph, operands cycled past L2), copied from
# PERF.md section 6's tables "Kernel 1 per shape", "Kernel 4 per shape",
# "Kernel 5 per shape" and "Kernel 6 per shape" (the first run of each
# table, run B for kernel 1, run A for the others).  ms a call.
# kernel 1: (M, K, N, trans_b, out bytes) -> ms at slots 2, 1, 4 (bk 128)
K1 = [((4, 3072, 4096, False, 2), 0.0129, 0.0142, 0.0122),
      ((4, 4096, 3072, False, 2), 0.0127, 0.0153, 0.0134),
      ((4, 3072, 24576, False, 2), 0.0521, 0.0520, 0.0534),
      ((4, 24576, 3072, False, 2), 0.0521, 0.0605, 0.0536),
      ((4, 3072, 256000, True, 4), 0.5031, 0.5141, 0.5025),
      ((128, 3072, 4096, False, 2), 0.0182, None, None),
      ((128, 4096, 3072, False, 2), 0.0179, None, None),
      ((128, 3072, 24576, False, 2), 0.0771, None, None),
      ((128, 24576, 3072, False, 2), 0.0621, None, None),
      ((1, 3072, 256000, True, 4), 0.4971, None, None)]
# kernel 4: (M, K, N) -> ms at (slots, bk) (2, 256), (1, 256), (4, 256),
# (2, 128)
K4 = [((4, 3072, 4096), 0.0104, 0.0117, 0.0103, 0.0117),
      ((4, 4096, 3072), 0.0105, 0.0124, 0.0106, 0.0117),
      ((4, 3072, 24576), 0.0319, 0.0316, 0.0326, 0.0312),
      ((4, 24576, 3072), 0.0314, 0.0373, 0.0318, 0.0351),
      ((128, 3072, 4096), 0.0175, None, None, None),
      ((128, 4096, 3072), 0.0163, None, None, None),
      ((128, 3072, 24576), 0.0584, None, None, None),
      ((128, 24576, 3072), 0.0425, None, None, None)]
# kernel 6: (G, C, K, N) -> ms at (slots, bk) (2, 256), (1, 256),
# (4, 256), (1, 128), (2, 128), (4, 128)
K6 = [((64, 1, 2048, 1024), 0.0509, 0.0551, 0.0499, 0.0667, 0.0543, 0.0517),
      ((64, 1, 1024, 2048), 0.0566, 0.0577, 0.0574, 0.0697, 0.0573, 0.0571),
      ((64, 20, 2048, 1024), 0.0594, 0.0656, 0.0587, 0.0778, 0.0638, 0.0605),
      ((64, 20, 1024, 2048), 0.0695, 0.0765, 0.0711, 0.0885, 0.0745, 0.0708)]
K6_CONFIGS = ((2, 256), (1, 256), (4, 256), (1, 128), (2, 128), (4, 128))
# kernel 5: (G, C, K, N) -> ms at slots 2, 1, 4 (bk 128)
K5 = [((64, 1, 2048, 1024), 0.0877, 0.0941, 0.0883),
      ((64, 1, 1024, 2048), 0.0876, 0.0956, 0.0884),
      ((64, 20, 2048, 1024), 0.0930, None, None),
      ((64, 20, 1024, 2048), 0.0946, None, None)]
# a gemma-7b decode step (M = 4): each layer's wq, wk, wv, wo, wi, wg, wo
GEMMA_LAYER = ((0, 3), (1, 1), (2, 2), (3, 1))
# the factors each table is held to: the model is fitted to these tables
# and to TABLES below, and is within 1.22x of every kernel-1 row and 1.63x
# of every row of kernels 4-6 (the int8 prefill products, which it
# prices low)
K1_FACTOR = 1.3
K456_FACTOR = 1.75

MODEL = HopperPipelineModel()


def _k1(i, slots):
    (M, K, N, tb, ob) = K1[i][0]
    return MODEL.matmul(M, N, K, 128, 128, 128, dtype_bytes=2, slots=slots,
                        trans_b=tb, out_bytes=ob).total_s * 1e3


def _k4(i, slots, bk):
    M, K, N = K4[i][0]
    return MODEL.matmul(M, N, K, 128, 128, bk, dtype_bytes=1, slots=slots,
                        trans_b=True, out_bytes=2).total_s * 1e3


def _k6(i, slots, bk):
    G, C, K, N = K6[i][0]
    return MODEL.matmul(C, N, K, 128, 128, bk, dtype_bytes=1, slots=slots,
                        groups=G, trans_b=True, out_bytes=2).total_s * 1e3


def _k5(i, slots):
    G, C, K, N = K5[i][0]
    return MODEL.matmul(C, N, K, 128, 128, 128, dtype_bytes=2, slots=slots,
                        groups=G, out_bytes=2).total_s * 1e3


def _within(pred, meas, factor):
    return max(pred / meas, meas / pred) <= factor


@pytest.mark.parametrize("i", range(len(K1)))
def test_model_predicts_each_kernel1_row(i):
    for slots, meas in zip((2, 1, 4), K1[i][1:]):
        if meas is not None:
            assert _within(_k1(i, slots), meas, K1_FACTOR), (K1[i], slots)


def test_model_predicts_kernels_4_5_6_rows():
    for i, (_, *ms) in enumerate(K4):
        for (slots, bk), meas in zip(((2, 256), (1, 256), (4, 256),
                                      (2, 128)), ms):
            if meas is not None:
                assert _within(_k4(i, slots, bk), meas, K456_FACTOR)
    for i, (_, *ms) in enumerate(K6):
        for (slots, bk), meas in zip(K6_CONFIGS, ms):
            assert _within(_k6(i, slots, bk), meas, K456_FACTOR)
    for i, (_, *ms) in enumerate(K5):
        for slots, meas in zip((2, 1, 4), ms):
            if meas is not None:
                assert _within(_k5(i, slots), meas, K456_FACTOR)


def test_model_orders_the_measured_ring_and_k_tile_choices():
    """What PERF.md section 6 ranks: kernel 1's decode step slower at one
    stage than two (6.815 against 6.364 ms); kernel 4's W8A8 step slower
    at bk 128 than 256 at two stages (4.041 against 3.828 ms); kernel 6's
    olmoe step slower at bk 128 than 256 at one and two stages (3.250
    against 2.686, 2.654 against 2.533 ms)."""
    def step1(slots):
        return 28 * sum(n * _k1(i, slots) for i, n in GEMMA_LAYER) \
            + _k1(4, slots)

    def step4(slots, bk):
        return 28 * sum(n * _k4(i, slots, bk) for i, n in GEMMA_LAYER)

    def step6(slots, bk):
        return 16 * (2 * _k6(0, slots, bk) + _k6(1, slots, bk))

    assert step1(1) > step1(2)
    assert _within(step1(2), 6.364, K1_FACTOR)
    assert step4(2, 128) > step4(2, 256)
    assert step6(1, 128) > step6(1, 256)
    assert step6(2, 128) > step6(2, 256)


# Every candidate of the tune space at 25 main-path shapes, measured on
# the card (the file's header gives the method): the analytic tuner's
# choice among them is held to the measured best and to the default.
TABLES = Path(__file__).resolve().parent / "data" / "h100_matmul_tables.csv"
# the analytic choice is within 1.18x of the measured best at every shape
# (1.04x on average) and never slower than the default beyond the
# tables' noise; the model's log error over all 1903 rows is 0.28 rms
# (it prices a block that owns 8 of 128 rows at half its time)
TABLE_REGRET = 1.2
TABLE_RMS_LOG = 0.3


def _tables() -> dict:
    with open(TABLES) as f:
        rows = list(csv.DictReader(ln for ln in f if not ln.startswith("#")))
    out: dict = {}
    for r in rows:
        key = (r["op"], int(r["groups"]), int(r["M"]), int(r["N"]),
               int(r["K"]), int(r["dtype_bytes"]))
        c = Candidate(int(r["bm"]), int(r["bn"]), int(r["bk"]),
                      int(r["slots"]), "ijk")
        out.setdefault(key, {})[c] = float(r["us"])
    return out


def test_model_choices_hold_on_the_measured_tables():
    tables = _tables()
    assert len(tables) == 25 and sum(map(len, tables.values())) == 1903
    oracle = AnalyticOracle()
    regrets, logs = [], []
    for (op, G, M, N, K, eb), meas in tables.items():
        p = Problem(op, M, N, K, eb, G)
        pred = {c: oracle.estimate(c, p) for c in meas}
        logs += [math.log(1e6 * pred[c] / meas[c]) for c in meas]
        choice = min(pred, key=pred.get)
        default = DEFAULT_SPACE.default(p)
        if pred[default] <= pred[choice] * (1 + tune.MIN_GAIN):
            choice = default
        regrets.append(meas[choice] / min(meas.values()))
        assert regrets[-1] <= TABLE_REGRET, (p, choice)
        assert meas[choice] <= 1.02 * meas[default], (p, choice)
    assert sum(regrets) / len(regrets) < 1.06
    assert math.sqrt(sum(x * x for x in logs) / len(logs)) < TABLE_RMS_LOG


# flash attention, bf16: (batch * heads, Sq, Skv, D, causal, bq, bkv) ->
# ms a call, on the same card: gemma-7b's prefill at every legal tile
# (chip_smoke.py phase 5m (a), the least of a tile's measurements), and
# PERF.md section 6's row 2 at zamba2's, olmoe's, llava's and seamless's
# shapes (the tiles their paths run)
FLASH = [((16, 128, 128, 256, True, 32, 32), 0.0204),
         ((16, 128, 128, 256, True, 16, 32), 0.0261),
         ((16, 128, 128, 256, True, 16, 16), 0.0293),
         ((16, 128, 128, 256, True, 32, 16), 0.0232),
         ((16, 128, 128, 256, True, 64, 16), 0.0202),
         ((16, 128, 128, 256, True, 64, 32), 0.0190),
         ((32, 128, 128, 80, True, 32, 32), 0.0130),
         ((16, 128, 128, 128, True, 32, 32), 0.0136),
         ((56, 3008, 3008, 128, True, 32, 32), 1.0644),
         ((64, 1, 128, 64, False, 16, 32), 0.0125)]
# the model is within 1.27x of every row (llava's 3008-row prefill, which
# it prices high)
FLASH_FACTOR = 1.3


def test_model_prices_flash_and_picks_its_measured_best_tile():
    for (bh, sq, skv, d, causal, bq, bkv), ms in FLASH:
        est = MODEL.attention(bq, bkv, s_q=sq, s_kv=skv, head_dim=d,
                              batch_heads=bh, causal=causal)
        assert _within(est.total_s * 1e3, ms, FLASH_FACTOR), (bh, sq, bq)
    measured = {row[5:]: ms for row, ms in FLASH[:6]}
    got = tune.best_attention_config(128, 128, 256, dtype=torch.bfloat16,
                                     batch_heads=16)
    assert measured[got] == min(measured.values())


def test_model_reads_the_device_where_it_can(monkeypatch):
    class Props:
        multi_processor_count = 114
        L2_cache_size = 50 * 2 ** 20
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index=0: Props)
    p = HopperParams.from_device(0)
    assert p.sms == 114 and p.smem_per_block == 232448
    assert p.hbm_bw == 3.35e12 and p.peak("bfloat16") == 989e12
    est = HopperPipelineModel(p).matmul(4, 4096, 3072, 128, 128, 128)
    assert est.splits == zs.split_plan(4, 4096, 3072, 128, 128, 128, 114)[0]
    assert 0 < est.utilization <= 1


# ----------------------------------------------------------------------
# the measured oracle
# ----------------------------------------------------------------------
def test_measured_oracle_runs_on_the_cpu_only_when_named():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeasuredOracle()
    oracle = MeasuredOracle(device="cpu", calls=2, repeats=1)
    with obs.capture() as sink:
        for p in (Problem("matmul", 4, 64, 48, 2),
                  Problem("grouped_matmul", 3, 32, 64, 1, 2)):
            assert oracle.estimate(SMALL_SPACE.default(p), p) > 0
        assert oracle.estimate_attention(16, 16, s_q=16, s_kv=16,
                                         head_dim=32, batch_heads=2) > 0
    events = [r for r in sink.records if r["name"] == "tune.measure"]
    assert [e["op"] for e in events] == ["matmul", "grouped_matmul",
                                         "attention"]
    assert all(e["device"] == "cpu" for e in events)
    res = tsearch.search(SMALL_SPACE, oracle, Problem("matmul", 4, 64, 48, 2))
    assert res.best in set(SMALL_SPACE.candidates(
        Problem("matmul", 4, 64, 48, 2)))


@pytest.mark.gpu
def test_measured_oracle_on_card(cuda):
    """A short measured search on the card: every candidate launches and
    the measured default is within 3x of the analytic prediction."""
    oracle = MeasuredOracle(calls=10, repeats=2)
    p = Problem("matmul", 4, 4096, 3072, 2)
    d = DEFAULT_SPACE.default(p)
    t = oracle.estimate(d, p)
    pred = AnalyticOracle().estimate(d, p)
    assert math.isfinite(t) and pred / 3 < t < pred * 3
    res = tsearch.search(SMALL_SPACE, oracle, p)
    assert res.best in set(SMALL_SPACE.candidates(p))
    assert np.isfinite(res.predicted_s)
