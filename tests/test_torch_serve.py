"""The port's serving engine against the JAX package's lock-step oracle.

Greedy tokens through ``repro_torch.serve.ServeEngine`` must equal JAX
``lockstep_generate`` on the same converted weights, at K = 1 and K = 4,
with mixed prompt lengths and requests retiring mid-block.  Also:
eos handling, one host sync per dispatch, the sampling contract, the
device rule of the entry points, and that the port imports neither JAX
nor the JAX package.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.serve import lockstep_generate as j_lockstep
from repro.serve import sampling as j_sampling
from repro.obs.metrics import summarize as j_summarize
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.launch.serve import serve_batch
from repro_torch.models import Ctx, build_model
from repro_torch.obs.metrics import summarize
from repro_torch.serve import (EngineStats, Request, ServeEngine,
                               lockstep_generate)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import sampling
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CTX = Ctx(plan="auto", dtype=torch.float32)
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
MAX_NEW = [6, 3, 5, 7]


def _prompts(vocab, lens=(5, 11, 3, 8)):
    return [list(np.random.default_rng(i).integers(0, vocab, n))
            for i, n in enumerate(lens)]


def _pair(arch):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


@pytest.fixture(scope="module")
def gemma():
    return _pair("gemma-7b")


def _engine(m, tp, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 32)
    return ServeEngine(m, tp, CTX, device="cpu", **kw)


def _run(engine, prompts, max_new, **req_kw):
    res = engine.run([Request(rid=i, prompt=p, max_new_tokens=n, **req_kw)
                      for i, (p, n) in enumerate(zip(prompts, max_new))])
    return [res[i].tokens for i in range(len(prompts))]


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-coder-33b"])
def test_engine_matches_jax_lockstep(arch, K):
    jm, jp, m, tp = _pair(arch)
    prompts = _prompts(256)
    oracle = j_lockstep(jm, jp, J_CTX, prompts, MAX_NEW, max_len=32)
    engine = _engine(m, tp, steps_per_dispatch=K)
    assert _run(engine, prompts, MAX_NEW) == oracle
    s = engine.stats
    assert s.admitted == s.retired == 4 and s.max_concurrent <= 2
    assert s.prefill_tokens == sum(map(len, prompts))
    assert s.decode_steps == s.dispatches * K
    # the port's own lock-step oracle agrees on both backends
    for backend in ("auto", "torch"):
        assert lockstep_generate(m, tp, Ctx(plan=backend,
                                            dtype=torch.float32),
                                 prompts, MAX_NEW, max_len=32,
                                 device="cpu") == oracle


def test_engine_eos_by_first_occurrence(gemma):
    """eos is a token that greedy decode emits, picked at its FIRST
    occurrence in request 0's stream, so request 0 stops exactly there."""
    jm, jp, m, tp = gemma
    prompts = _prompts(256)
    oracle = j_lockstep(jm, jp, J_CTX, prompts, 8, max_len=32)
    first = [j for j in range(1, 8) if oracle[0][j] not in oracle[0][:j]]
    assert first, "request 0 repeats one token: no usable eos"
    stop = first[0]
    eos = oracle[0][stop]

    def truncate(toks):
        return toks[:toks.index(eos) + 1] if eos in toks else toks

    outs = {K: _run(_engine(m, tp, steps_per_dispatch=K, eos_id=eos),
                    prompts, [8] * 4) for K in (1, 4)}
    assert outs[1] == outs[4]
    assert outs[4] == [truncate(o) for o in oracle]
    assert outs[4][0][-1] == eos and len(outs[4][0]) == stop + 1


def test_engine_one_host_sync_per_dispatch(gemma, monkeypatch):
    _, _, m, tp = gemma
    counter = {"n": 0}
    real = engine_mod._host

    def counting_host(x):
        counter["n"] += 1
        return real(x)

    monkeypatch.setattr(engine_mod, "_host", counting_host)
    engine = _engine(m, tp, steps_per_dispatch=4)
    _run(engine, _prompts(256), [6] * 4)
    s = engine.stats
    assert counter["n"] == s.admitted + s.dispatches
    assert s.dispatches < s.decode_tokens


def test_all_greedy_pool_takes_the_argmax_block(gemma):
    _, _, m, tp = gemma

    def run(temp):
        engine = _engine(m, tp, steps_per_dispatch=4)
        used = []
        real = engine._decode_block

        def spy(*a, greedy_only):
            used.append(greedy_only)
            return real(*a, greedy_only=greedy_only)

        engine._decode_block = spy
        _run(engine, _prompts(256), [4] * 4, temperature=temp)
        return used

    assert set(run(0.0)) == {True}
    assert set(run(0.7)) == {False}


def test_stochastic_sampling_is_block_and_batch_invariant(gemma):
    _, _, m, tp = gemma
    prompts = _prompts(256)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)

    def run(K, seed, subset=range(4)):
        engine = _engine(m, tp, steps_per_dispatch=K, seed=seed)
        res = engine.run([Request(rid=i, prompt=prompts[i],
                                  max_new_tokens=MAX_NEW[i], **kw)
                          for i in subset])
        return {i: res[i].tokens for i in subset}

    a = run(1, seed=7)
    assert run(4, seed=7) == a                     # block-size invariant
    assert run(1, seed=7) == a                     # reproducible
    assert run(4, seed=7, subset=[2]) == {2: a[2]}  # alone == in a batch
    assert run(1, seed=8) != a                     # seeds diversify
    for i, toks in a.items():
        assert len(toks) == MAX_NEW[i] and all(0 <= t < 256 for t in toks)


def test_request_seed_overrides_engine_seed(gemma):
    _, _, m, tp = gemma
    prompts = _prompts(256)[:2]

    def run(seed):
        return _run(_engine(m, tp, seed=seed), prompts, [5, 5],
                    temperature=1.0, seed=11)

    assert run(0) == run(1)


def test_top_k_top_p_mask_matches_jax(rng):
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[1, 3] = logits[1, 7] = 5.0           # a tie at the top
    top_k = np.array([0, 2, 10, 60], np.int32)
    top_p = np.array([1.0, 0.5, 0.9, 0.3], np.float32)
    want = j_sampling._mask_top_k_top_p(jnp.asarray(logits),
                                        jnp.asarray(top_k),
                                        jnp.asarray(top_p))
    got = sampling._mask_top_k_top_p(torch.from_numpy(logits),
                                     torch.from_numpy(top_k),
                                     torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sampling.greedy(torch.from_numpy(logits)).tolist() == \
        np.asarray(j_sampling.greedy(jnp.asarray(logits))).tolist()


def test_sampling_greedy_rows_ignore_generators():
    """The key form of the old per-row generator contract: greedy rows
    return their exact argmax whatever their key, and every row's key
    advances by one split."""
    logits = torch.randn(3, 40, generator=torch.Generator().manual_seed(0))
    temp = torch.tensor([0.0, 1.0, 0.0])
    knobs = (torch.zeros(3, dtype=torch.int32), torch.ones(3))
    keys = torch.stack([sampling.request_key(s) for s in (0, 1, 2)])
    other = torch.stack([sampling.request_key(s) for s in (5, 6, 7)])
    new_keys, toks = sampling.sample(logits, keys, temp, *knobs)
    toks2 = sampling.sample(logits, other, temp, *knobs)[1]
    assert toks.dtype == torch.int32
    assert toks[0] == logits[0].argmax() and toks[2] == logits[2].argmax()
    assert toks2[0] == toks[0] and toks2[2] == toks[2]
    assert torch.equal(new_keys, sampling.split(keys)[:, 0])


def test_request_validation_and_stats():
    with pytest.raises(ValueError, match="empty prompt"):
        Request(rid=0, prompt=[], max_new_tokens=1)
    with pytest.raises(ValueError, match="top_p"):
        Request(rid=0, prompt=[1], max_new_tokens=1, top_p=0.0)
    xs = [0.3, 0.1, 0.7, 0.2]
    assert summarize(xs) == j_summarize(xs)
    snap = EngineStats(num_slots=2).snapshot()
    assert snap["num_slots"] == 2 and snap["ttft"]["n"] == 0


def _stats_pair(cls, i):
    s = cls(num_slots=2 + i)
    for k, v in dict(prefill_s=0.5 + i, decode_s=1.25, prefill_tokens=10,
                     decode_tokens=7 + i, decode_steps=4, dispatches=2,
                     admitted=3, retired=3 - i, max_concurrent=2,
                     pages_in_use=5 * i, pages_shared=i,
                     prefill_chunks=2).items():
        setattr(s, k, v)
    s.ttft_s.extend([0.1 * (i + 1), 0.3])
    s.queue_wait_s.append(0.05 * i)
    s.token_latency_s.extend([0.01, 0.02 + i])
    s.dispatch_occupancy.extend([1.0, 0.5 * i])
    s.replica_id = i
    return s


def test_engine_stats_merge_and_dict_shim_match_jax():
    """``EngineStats.merge`` and the deprecated dict access against JAX's
    on the same counters: equal snapshots (the merged ``replica_id``
    None), the same warnings, keys and KeyErrors."""
    from repro.serve.stats import EngineStats as JStats
    parts = [_stats_pair(EngineStats, i) for i in range(3)]
    jparts = [_stats_pair(JStats, i) for i in range(3)]
    assert [p.snapshot() for p in parts] == [p.snapshot() for p in jparts]
    merged, jmerged = EngineStats.merge(parts), JStats.merge(jparts)
    assert merged.snapshot() == jmerged.snapshot()
    assert merged.replica_id is None and merged.num_slots == 9
    assert merged.max_concurrent == 6 and merged.ttft_s == jmerged.ttft_s
    for stats in (merged, jmerged):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            assert stats["decode_tokens"] == 24
        with pytest.warns(DeprecationWarning):
            stats["admitted"] = 11
        assert stats.admitted == 11
        assert "retired" in stats and "pages_in_use" not in stats
        with pytest.warns(DeprecationWarning), pytest.raises(KeyError):
            stats["pages_in_use"]
        with pytest.warns(DeprecationWarning), pytest.raises(KeyError):
            stats["ttft_s"] = []
    with pytest.warns(DeprecationWarning):
        legacy = dict(merged)
    with pytest.warns(DeprecationWarning):
        assert legacy == dict(jmerged)
    assert list(legacy) == ["prefill_s", "decode_s", "prefill_tokens",
                            "decode_tokens", "decode_steps", "dispatches",
                            "admitted", "retired", "max_concurrent"]


def test_engine_rejects_what_slice_two_brings(gemma):
    """Paging and chunked prefill came with slice 2 of the port, plans
    with slice 10 and plan validation with slice 11: ``validate=True``
    now lints the active plan and builds the engine.  A plan argument
    outside the vocabulary raises."""
    _, _, m, tp = gemma
    with pytest.raises(ValueError, match="execution plan"):
        _engine(m, tp, plan=object())
    assert _engine(m, tp, validate=True).plan is not None
    _engine(m, tp, page_size=8, prefill_chunk=4)
    engine = _engine(m, tp)
    with pytest.raises(ValueError, match="exceeds max_len"):
        engine.submit(Request(rid=0, prompt=[1] * 30, max_new_tokens=5))


def test_serve_batch_on_cpu():
    out = serve_batch("gemma-7b", batch=4, prompt_len=8, gen_len=6,
                      mixed=True, num_slots=2, steps_per_dispatch=4,
                      device="cpu")
    assert out["generated"].shape == (4, 6)
    assert ((out["generated"] >= 0) & (out["generated"] < 256)).all()
    plain = serve_batch("gemma-7b", batch=4, prompt_len=8, gen_len=6,
                        mixed=True, num_slots=2, backend="torch",
                        device="cpu")
    np.testing.assert_array_equal(out["generated"], plain["generated"])
    assert out["stats"]["retired"] == 4


def test_serve_batch_paged_and_chunked_on_cpu():
    kw = dict(batch=4, prompt_len=8, gen_len=8, mixed=True, num_slots=2,
              steps_per_dispatch=4, device="cpu")
    base = serve_batch("gemma-7b", **kw)
    out = serve_batch("gemma-7b", page_size=4, prefill_chunk=3, **kw)
    np.testing.assert_array_equal(out["generated"], base["generated"])
    s = out["stats"]
    # prompts of 8, 4, 2 and 6 tokens in chunks of 3: 3 + 2 + 2 chunks
    assert s["pages_in_use"] > 0 and s["prefill_chunks"] == 7
    assert base["stats"]["pages_in_use"] == base["stats"]["prefill_chunks"] \
        == 0


def test_entry_points_raise_without_a_device_when_cuda_is_absent(gemma):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, jp, m, tp = gemma
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(m, tp, CTX)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch("gemma-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lockstep_generate(m, tp, CTX, [[1, 2]], 2, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tensor_from_numpy(np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(jax.tree.map(np.asarray, jp),
                          get_config("gemma-7b", reduced=True))


_NO_JAX = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import torch
from repro_torch.launch.serve import serve_batch
out = serve_batch("deepseek-coder-33b", batch=2, prompt_len=6, gen_len=3,
                  device="cpu")
assert out["generated"].shape == (2, 3)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print("clean")
"""


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "tune.json"))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    runs = [subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120)]
    # a directory that holds chip_smoke.py and nothing else of the repo
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                               cwd=tmp_path, capture_output=True, text=True,
                               timeout=120))
    for out in runs:
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
