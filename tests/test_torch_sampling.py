"""The port's threefry sampling and the engine's decode block, against
the JAX package.

Key data and random bits are held bit-equal to ``jax.random`` (key
data is integer arithmetic, so there is no tolerance); sampled tokens
equal JAX's, where only the float ``log`` of the Gumbel noise may differ
by an ulp between XLA and torch.  A reduced gemma-7b engine in fp32
samples the tokens of the JAX ``ServeEngine`` (both on the CPU: the
port's plain path, JAX's ``jnp`` path) with per-request and
engine-derived seeds, at K = 1 and K = 4.  The block a CUDA graph
captures, run eagerly here, gives the tokens and leaves the ``pos`` and
keys of a plain Python loop of ``Model.decode`` calls.  The tests marked
``gpu`` capture the block on the card and skip without one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import sampling as j_sampling
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import launches
from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul
from repro_torch.models import Ctx, build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import sampling
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

SEEDS = [0, 1, 7, 2 ** 31 - 1]
KNOBS = dict(temperature=0.9, top_k=20, top_p=0.95)
CTX = Ctx(plan="auto", dtype=torch.float32)
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
MAX_NEW = [6, 3, 5, 7]


def _j_key(seed):
    return jax.random.PRNGKey(seed)


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


# ----------------------------------------------------------------------
# threefry: bit parity with jax.random
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_request_key_fold_in_and_split_bit_equal_to_jax(seed):
    key = sampling.request_key(seed)
    np.testing.assert_array_equal(key.numpy(),
                                  _np(j_sampling.request_key(seed)))
    for data in (0, 3, 2 ** 32 - 1):
        want = jax.random.key_data(jax.random.fold_in(_j_key(seed), data))
        np.testing.assert_array_equal(sampling.fold_in(key, data).numpy(),
                                      _np(want))
    for num in (2, 3):
        np.testing.assert_array_equal(sampling.split(key, num).numpy(),
                                      _np(jax.random.split(_j_key(seed),
                                                           num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_bit_equal_to_jax(seed):
    n = 1000
    key = sampling.request_key(seed)[None]
    np.testing.assert_array_equal(
        sampling.uniform_bits(key, n)[0].numpy(),
        _np(jax.random.bits(_j_key(seed), (n,), jnp.uint32)))
    tiny = np.finfo(np.float32).tiny
    want = jax.random.uniform(_j_key(seed), (n,), jnp.float32, minval=tiny,
                              maxval=1.0)
    got = sampling._uniform(sampling.uniform_bits(key, n))[0]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_sample_keys_bit_equal_and_tokens_equal_to_jax(rng):
    """Mixed knobs, greedy rows among them; 30 draws of 8 rows."""
    B, V = 8, 256
    temp = np.array([0.0, 0.5, 0.9, 1.0, 1.5, 0.0, 0.8, 2.0], np.float32)
    top_k = np.array([0, 20, 5, 0, 300, 3, 1, 50], np.int32)
    top_p = np.array([1.0, 0.95, 0.5, 1.0, 0.9, 0.2, 1.0, 0.99], np.float32)
    keys = np.stack([np.asarray(j_sampling.request_key(s))
                     for s in range(B)])
    for _ in range(30):
        logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
        jk, jt = j_sampling.sample(jnp.asarray(logits), jnp.asarray(keys),
                                   jnp.asarray(temp), jnp.asarray(top_k),
                                   jnp.asarray(top_p))
        tk, tt = sampling.sample(torch.from_numpy(logits),
                                 torch.from_numpy(keys.astype(np.int64)),
                                 torch.from_numpy(temp),
                                 torch.from_numpy(top_k),
                                 torch.from_numpy(top_p))
        np.testing.assert_array_equal(tk.numpy(), _np(jk))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert tt.dtype == torch.int32
        keys = np.asarray(jk)


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _prompts(vocab, lens=(5, 11, 3, 8)):
    return [list(np.random.default_rng(i).integers(0, vocab, n))
            for i, n in enumerate(lens)]


@functools.lru_cache(maxsize=None)
def _pair(arch="gemma-7b"):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


def _requests(cls, prompts, seeds, max_new=MAX_NEW):
    return [cls(rid=i, prompt=p, max_new_tokens=n, seed=s, **KNOBS)
            for i, (p, n, s) in enumerate(zip(prompts, max_new, seeds))]


# rids 0 and 2 bring their own seeds; 1 and 3 derive theirs from the
# engine seed and the rid
MIXED_SEEDS = [11, None, 2 ** 31 - 1, None]


@pytest.mark.parametrize("K", [1, 4])
def test_sampled_engine_tokens_equal_jax_engine(K):
    jm, jp, m, tp = _pair()
    prompts = _prompts(256)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=K, seed=5)
    j_eng = JServeEngine(jm, jp, J_CTX, **kw)
    want = j_eng.run(_requests(JRequest, prompts, MIXED_SEEDS))
    eng = ServeEngine(m, tp, CTX, device="cpu", **kw)
    got = eng.run(_requests(Request, prompts, MIXED_SEEDS))
    assert {i: r.tokens for i, r in got.items()} == \
        {i: r.tokens for i, r in want.items()}
    np.testing.assert_array_equal(eng._keys.numpy(), _np(j_eng._keys))


def test_sampled_engine_is_block_and_batch_invariant():
    _, _, m, tp = _pair()
    prompts = _prompts(256)

    def run(K, subset=range(4), slots=2):
        eng = ServeEngine(m, tp, CTX, device="cpu", num_slots=slots,
                          max_len=32, steps_per_dispatch=K, seed=5)
        res = eng.run([r for r in _requests(Request, prompts, MIXED_SEEDS)
                       if r.rid in subset])
        return {i: res[i].tokens for i in subset}

    a = run(1)
    assert run(4) == a
    assert run(4, slots=4) == a
    assert run(4, subset=[1]) == {1: a[1]}
    assert run(1, subset=[2, 3]) == {2: a[2], 3: a[3]}


# ----------------------------------------------------------------------
# the block function against a plain loop
# ----------------------------------------------------------------------
def _loop(eng, tok, done, budget, *, greedy_only):
    """The engine's block as a plain Python loop of ``Model.decode``
    calls over a copy of the engine's state: (tokens, pos, keys)."""
    cache = {k: v.clone() for k, v in eng.cache.items()}
    keys = eng._keys.clone()
    tok = torch.from_numpy(tok).long()
    done = torch.from_numpy(done)
    budget = torch.from_numpy(budget)
    temp, topk, topp = (torch.from_numpy(x) for x in
                        (eng._temp, eng._topk, eng._topp))
    out = []
    for _ in range(eng.steps_per_dispatch):
        logits, cache = eng.model.decode(eng.params, cache, tok[:, None],
                                         eng.ctx)
        if greedy_only:
            nxt = sampling.greedy(logits[:, -1])
        else:
            keys2, nxt = sampling.sample(logits[:, -1], keys, temp, topk,
                                         topp)
            keys = torch.where(done[:, None], keys, keys2)
        nxt = torch.where(done, tok, nxt.long())
        budget = budget - (~done).to(torch.int32)
        newly = budget <= 0
        if eng.eos_id is not None:
            newly = newly | (nxt == eng.eos_id)
        done = done | newly
        tok = nxt
        out.append(nxt)
    return torch.stack(out, dim=1), cache["pos"], keys


@pytest.mark.parametrize("greedy_only", [True, False])
@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
def test_block_equals_plain_loop_and_leaves_pos_and_keys(mode, greedy_only):
    _, _, m, tp = _pair()
    eng = ServeEngine(m, tp, CTX, device="cpu", num_slots=3, max_len=32,
                      steps_per_dispatch=4, eos_id=7, **mode)
    prompts = _prompts(256, (5, 9, 4))
    temp = 0.0 if greedy_only else 0.9
    for slot, p in enumerate(prompts):
        eng._admit(Request(rid=slot, prompt=p, max_new_tokens=8, seed=slot,
                           temperature=temp, top_k=20, top_p=0.95), slot)
    tok = np.array([3, 200, 17], np.int32)
    done = np.array([False, True, False])     # slot 1 is frozen
    budget = np.array([2, 0, 9], np.int32)    # slot 0 runs out mid-block
    want_tile, want_pos, want_keys = _loop(eng, tok, done, budget,
                                           greedy_only=greedy_only)
    keys0 = eng._keys.clone()
    tile = eng._decode_block(tok, done, budget, greedy_only=greedy_only)
    assert torch.equal(tile, want_tile)
    assert tile.shape == (3, 4) and bool((tile[1] == 200).all())
    assert torch.equal(eng.cache["pos"], want_pos)
    assert torch.equal(eng._keys, want_keys)
    assert torch.equal(eng._keys[1], keys0[1])    # a frozen row's key
    assert torch.equal(eng._keys, keys0) == greedy_only
    assert not eng.captures                      # nothing is captured here


# ----------------------------------------------------------------------
# launch bookkeeping of a captured graph
# ----------------------------------------------------------------------
def test_launch_counts_of_a_capture_are_added_once_a_replay():
    fn = zero_stall_matmul
    start = launches.snapshot()
    before = launches.snapshot()
    # what a capture's wrapper calls count (they launch nothing)
    fn.launches += 3
    fn.launches_by_design["sm90"] += 2
    fn.launches_by_design["ring"] += 1
    counts = launches.since(before)
    assert counts == {"zero_stall_matmul": 3, "zero_stall_matmul.sm90": 2,
                      "zero_stall_matmul.ring": 1}
    launches.add(counts, -1)
    assert launches.snapshot() == start
    for _ in range(5):
        launches.add(counts)
    now = launches.snapshot()
    assert now["zero_stall_matmul"] == start["zero_stall_matmul"] + 15
    assert now["zero_stall_matmul.sm90"] == start["zero_stall_matmul.sm90"] \
        + 10
    assert now["zero_stall_matmul.ring"] == start["zero_stall_matmul.ring"] \
        + 5
    launches.add(counts, -5)
    assert launches.snapshot() == start
    assert launches.since(start) == {}


# ----------------------------------------------------------------------
# on the card (skips here)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures its block "
                    "only on the card")
    return torch.device("cuda")


def _card_run(m, params, *, eager, K, mode, temperature):
    eng = ServeEngine(m, params, CTX, device="cuda", num_slots=2,
                      max_len=32, steps_per_dispatch=K, seed=5, **mode)
    if eager:
        # the private hook chip_smoke.py times the loop with: never
        # capture, so every dispatch runs the block eagerly
        eng._capture = lambda greedy_only: None
    before = launches.snapshot()
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=n, seed=i,
                           temperature=temperature, top_k=20, top_p=0.95)
                   for i, (p, n) in enumerate(zip(_prompts(256), MAX_NEW))])
    torch.cuda.synchronize()
    return ({i: r.tokens for i, r in res.items()}, launches.since(before),
            eng)


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
def test_graph_replay_equals_eager_block_on_card(cuda, mode, temperature):
    m = build_model(get_config("gemma-7b", reduced=True))
    params = m.init(seed=0, device=cuda)
    eager, eager_counts, _ = _card_run(m, params, eager=True, K=4,
                                       mode=mode, temperature=temperature)
    graph, graph_counts, eng = _card_run(m, params, eager=False, K=4,
                                         mode=mode, temperature=temperature)
    assert graph == eager
    assert graph_counts == eager_counts
    # the decode graph's variant, beside one prefill graph a bucket
    assert [c["variant"] for c in eng.captures
            if not c["variant"].startswith("prefill")] == [
        "greedy" if temperature == 0.0 else "sampled"]
    assert eng.stats.dispatches > 1
