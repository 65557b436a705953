"""The mix's ``engine`` object reaches ``ServeEngine`` whole, and the
configuration's dtype and quantisation reach the program: a mix that
names pages or prefill chunks builds an engine that runs them, and a key
``ServeEngine`` does not take is refused rather than ignored."""

import pytest
import torch

from perfbench import harness
from perfbench.test_perfbench_faults import CONFIG, MIX


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mix(**engine):
    return dict(MIX, engine=dict(MIX["engine"], **engine))


@pytest.mark.parametrize("engine,attr,value", [
    ({"page_size": 16}, "page_size", 16),
    ({"prefill_chunk": 8}, "_chunk", 8),
    ({"cache_dtype": "float32"}, "cache_dtype", torch.float32),
    ({}, "cache_dtype", torch.bfloat16),
], ids=["paged", "chunked", "cache-fp32", "cache-from-config"])
def test_the_mix_engine_reaches_the_engine(engine, attr, value):
    _, eng, _, _ = harness.build(CONFIG, _mix(**engine), 5, device="cpu")
    assert getattr(eng, attr) == value
    assert eng.num_slots == MIX["engine"]["num_slots"]
    assert eng.steps_per_dispatch == MIX["engine"]["steps_per_dispatch"]


@pytest.mark.parametrize("key", ["slots", "seed", "device", "ctx"])
def test_a_key_the_engine_does_not_take_is_refused(key):
    with pytest.raises(ValueError, match=key):
        harness.engine_kwargs(CONFIG, _mix(**{key: 4}))


def test_the_config_quantisation_reaches_the_program():
    from repro_torch.quant import QTensor
    cfg = dict(CONFIG, port={"quant": "int8"})
    assert harness.program_ctx(cfg).plan.quant == "int8"
    assert harness.program_ctx(CONFIG).plan.quant is None
    _, eng, _, _ = harness.build(cfg, MIX, 5, device="cpu")
    assert isinstance(eng.params["layers"][0]["attn"]["wq"]["w"], QTensor)


@pytest.mark.parametrize("key,value", [("hidden_act", "gelu"),
                                       ("tie_word_embeddings", True),
                                       ("attention_bias", True)])
def test_a_setting_the_reference_does_not_follow_is_refused(key, value):
    with pytest.raises(ValueError, match=key):
        harness.port_config(dict(CONFIG, **{key: value}))
