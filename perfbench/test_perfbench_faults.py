"""A run of the harness with the timed path broken underneath comes out
not correct; the same run unbroken comes out correct.

The runs skip the look for a chip (``device="cpu"``): a reduced dense
configuration, served by the port's engine on its plain path, every
other step of a run as the benchmark takes it.  The faults are those a
serving cell can have: a decode step that returns its state unchanged,
half of the slots' outputs left out (the mean of the others in their
place), and a token altered where it is produced: every token, or only
the first, which the prefill program produces.  A one-chip cell has no
exchange between chips to leave out.
"""

import dataclasses
import time

import pytest
import torch

from perfbench import harness
from perfbench.spec import Cell

CONFIG = {"dtype": "bfloat16", "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 1e4,
          "check": {"max_logit_gap": 0.1, "mean_logit_gap": 0.02,
                    "request_mean_gap": 0.02, "first_token_max_gap": 0.1}}
MIX = {"loop": "closed", "clients": 4, "block": 8,
       "prompt_len": {"median": 12, "sigma": 0.5, "min": 4, "max": 30},
       "output_len": {"median": 12, "sigma": 0.4, "min": 6, "max": 24},
       "sampling": {"temperature": 0.8, "top_p": 0.9, "top_k": 0},
       "greedy_share": 0.5,
       "engine": {"num_slots": 4, "steps_per_dispatch": 2, "max_len": 64},
       "ramp_seconds": 0.2, "trace_seconds": 0.5,
       "check": {"min_tokens": 60, "max_requests": 6, "first_tokens": 6}}
CELL = Cell(name="tiny", chips=1,
            config=CONFIG, traffic=MIX,
            end_to_end=("out_tok_s", "tpot_p95_ms", "setup_s"),
            per_layer=(), units={"out_tok_s": "tokens/s",
                                 "tpot_p95_ms": "ms"})


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    """A private tuning cache, and one thread: the tiny model gains
    nothing from more, and the suite runs several workers at once."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(faults=None, seed=2 ** 31 + 3):
    return harness.run_cell(CELL, seed, 0.8, False,
                            t_process=time.perf_counter(), device="cpu",
                            faults=faults)


def _wrap_decode(eng, body):
    orig = eng.model.decode

    def decode(params, cache, tokens, ctx):
        return body(orig, params, cache, tokens, ctx)
    eng.model = dataclasses.replace(eng.model, decode=decode)


def _state_unchanged(eng):
    def body(orig, params, cache, tokens, ctx):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, _ = orig(params, cache, tokens, ctx)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache
    _wrap_decode(eng, body)


def _half_batch(eng):
    def body(orig, params, cache, tokens, ctx):
        logits, new = orig(params, cache, tokens, ctx)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:half].mean(0, keepdim=True)
        return logits, new
    _wrap_decode(eng, body)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] <= 0.1
    assert out["checks"]["served_tokens"]["value"] >= 6
    assert out["checks"]["first_tokens"]["value"] >= 1
    assert out["checks"]["first_token_max_gap"]["value"] <= 0.1
    assert out["checks"]["request_mean_gap"]["value"] <= 0.02
    assert set(out["metrics"]) == {"out_tok_s", "tpot_p95_ms", "setup_s"}
    # set-up's phases are given apart, and the checks come last
    assert set(out["setup"]) == {"start", "weights", "engine", "captures",
                                 "ramp"}
    assert sum(out["setup"].values()) <= out["metrics"]["setup_s"]["value"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
def test_a_broken_decode_is_not_correct(fault):
    out = _run(fault)
    assert not out["correct"], out["checks"]


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from repro_torch.serve import sampling
    greedy = sampling.greedy

    def altered(logits):
        return (greedy(logits) + 1) % logits.shape[-1]
    monkeypatch.setattr(sampling, "greedy", altered)
    out = _run()
    assert not out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] > 0.1


def test_a_first_token_altered_where_prefill_produces_it_is_not_correct():
    def first_altered(eng):
        orig = eng._first_token

        def first(req, slot, logits):
            return (orig(req, slot, logits) + 1) % logits.shape[-1]
        eng._first_token = first
    out = _run(first_altered)
    assert not out["correct"], out["checks"]
    assert out["checks"]["first_token_max_gap"]["value"] > 0.1
