"""``repro_torch.obs.kernel_watch`` against the JAX package's.

The records a prefill and a decode leave, by (op, M, N, K, groups,
dtype), equal JAX's (the JAX package run as its own tests run it on the
CPU: the Pallas kernels in interpret mode), contiguous and paged; the
port's ``count`` (eager dispatches); the utilization table's columns,
priced by the Hopper model; and its measured column on the card only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import tune as jtune
from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import Plan as JPlan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import obs, tune
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.serve import Request, ServeEngine
import torch_tune_cache  # noqa: F401 (pins torch's threads)

J_CTX = JCtx(plan=JPlan(backend="interpret"), dtype=jnp.float32)
CTX = Ctx(plan="auto", dtype=torch.float32)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


@pytest.fixture(autouse=True)
def clean(tmp_path):
    """Both packages' tune caches on temporary files, both packages'
    records empty before and after."""
    jtune.set_cache(jtune.TuneCache(tmp_path / "jax_tune.json"))
    tune.set_cache(tune.TuneCache(tmp_path / "tune.json"))
    jobs.reset_records()
    obs.reset_records()
    yield
    jobs.reset_records()
    obs.reset_records()
    jtune.set_cache(None)
    tune.set_cache(None)


def _pair(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


def _rows(records):
    return {(r.op, r.M, r.N, r.K, r.groups, r.dtype) for r in records}


@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2"])
def test_records_of_a_prefill_and_a_decode_match_jax(arch):
    jm, jp, m, tp = _pair(arch)
    cfg = m.cfg
    tokens = np.array([PROMPT])
    jb = {"tokens": jnp.asarray(tokens),
          "lengths": jnp.asarray([len(PROMPT)], jnp.int32)}
    tb = {"tokens": torch.tensor(tokens, dtype=torch.int32),
          "lengths": torch.tensor([len(PROMPT)], dtype=torch.int32)}
    if cfg.family == "encdec":
        frames = np.random.default_rng(0).standard_normal(
            (1, 6, cfg.d_model)).astype(np.float32) * 0.1
        jb["frontend_embeds"] = jnp.asarray(frames)
        tb["frontend_embeds"] = torch.tensor(frames)
    with jobs.capture():
        _, jcache = jm.prefill(jp, jb, J_CTX, 16)
        jm.decode(jp, jcache, jnp.asarray([[7]], jnp.int32), J_CTX)
    with obs.capture():
        _, cache = m.prefill(tp, tb, CTX, 16)
        m.decode(tp, cache, torch.tensor([[7]], dtype=torch.int32), CTX)
    assert _rows(obs.recorded_ops()) == _rows(jobs.recorded_ops())
    assert all(r.config is not None for r in obs.recorded_ops())


def test_records_of_a_paged_engine_match_jax():
    """A paged engine's run records paged attention as an attention of
    H // KV query rows over T * ps keys, as the JAX engine does."""
    jm, jp, m, tp = _pair("deepseek-coder-33b")
    kw = dict(num_slots=2, max_len=16, page_size=4)
    jeng = JServeEngine(jm, jp, J_CTX, **kw)
    eng = ServeEngine(m, tp, CTX, device="cpu", **kw)
    with jobs.capture():
        jeng.run([JRequest(rid=0, prompt=PROMPT, max_new_tokens=3)])
    with obs.capture():
        eng.run([Request(rid=0, prompt=PROMPT, max_new_tokens=3)])
    rows = _rows(obs.recorded_ops())
    assert rows == _rows(jobs.recorded_ops())
    cfg = m.cfg
    paged = ("attention", cfg.n_heads // cfg.n_kv_heads,
             cfg.resolved_head_dim, 16, 1, "float32")
    assert paged in rows
    assert [r.config for r in obs.recorded_ops()
            if (r.op, r.M, r.K) == paged[:2] + (16,)] == [None]


def test_count_is_eager_dispatches():
    """The port counts each Python dispatch of an entry point: a second
    decode step doubles every decode record; recording is off unless
    observability is on."""
    _, _, m, tp = _pair("gemma-7b")
    tb = {"tokens": torch.tensor([PROMPT], dtype=torch.int32)}
    _, cache = m.prefill(tp, tb, CTX, 16)
    assert obs.recorded_ops() == []
    tok = torch.tensor([[7]], dtype=torch.int32)
    with obs.capture():
        _, cache = m.decode(tp, cache, tok, CTX)
    once = {r.key: r.count for r in obs.recorded_ops()}
    with obs.capture():
        m.decode(tp, cache, tok, CTX)
    assert {r.key: r.count for r in obs.recorded_ops()} == \
        {k: 2 * n for k, n in once.items()}
    L = m.cfg.n_layers
    assert sum(n for (op, *_), n in once.items() if op == "matmul") == \
        7 * L + 1


def test_utilization_table_prices_each_record():
    _, _, m, tp = _pair("gemma-7b")
    tb = {"tokens": torch.tensor([PROMPT], dtype=torch.int32)}
    with obs.capture():
        m.prefill(tp, tb, CTX, 16)
    rows = obs.utilization_table()
    assert len(rows) == len(obs.recorded_ops()) > 0
    for row in rows:
        assert 0 < row["bound_s"] <= row["predicted_s"]
        assert 0 < row["predicted_util"] <= 1
        assert row["measured_s"] is None and row["measured_util"] is None
        assert row["config"] != "default"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            obs.utilization_table(measure=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_utilization_table_measures_on_card(cuda):
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, dtype=torch.bfloat16, device=cuda)
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    cache = m.init_cache(2, 16, torch.bfloat16, device=cuda)
    cache["pos"] = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with obs.capture():
        m.decode(params, cache, torch.ones((2, 1), dtype=torch.int32,
                                           device=cuda), ctx)
    rows = obs.utilization_table(measure=True, calls=5, repeats=1)
    assert rows and all(r["measured_s"] > 0 and r["measured_util"] > 0
                        for r in rows)
