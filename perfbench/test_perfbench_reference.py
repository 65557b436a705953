"""The plain reference held to the port's plain path (``Ctx(plan="torch")``)
at reduced sizes of both configurations, and the weights the program and
the reference draw from one seed."""

import dataclasses

import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import model as reference
from perfbench.spec import model_spec

DENSE = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
         "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 16,
         "vocab_size": 128, "rms_norm_eps": 1e-5, "rope_theta": 1e6}
MOE = {"hidden_size": 64, "intermediate_size": 32, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 4,
       "vocab_size": 128, "rms_norm_eps": 1e-5, "rope_theta": 1e4,
       "num_experts": 8, "num_experts_per_tok": 2, "norm_topk_prob": True}


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float(v) for v in tree]
    return tree.to(torch.float32)


def _port_logits(config, tokens, seed):
    from repro_torch.models import Ctx, build_model, transformer
    from repro_torch.models.model import _moe_mlp_fn
    spec = model_spec(config)
    cfg = harness.port_config(config)
    params = _float(weights.program_params(spec, seed, "cpu"))
    ctx = Ctx(plan="torch", dtype=torch.float32)
    mlp = _moe_mlp_fn(cfg, ctx) if spec.family == "moe" else None
    with torch.no_grad():
        return transformer.forward(params, tokens, build_model(cfg).cfg, ctx,
                                   mlp_fn=mlp)


@pytest.mark.parametrize("config", [
    DENSE, dict(MOE, port={"capacity_factor": 4.0}),
    dict(MOE, port={"capacity_factor": 1.25})],
    ids=["dense-gqa", "moe-dropless", "moe-capacity-drops"])
def test_reference_equals_the_ports_plain_path(config):
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 128, (3, 24), generator=g)
    seed = 2 ** 31 + 17
    want = _port_logits(config, tokens, seed)
    got = reference.forward(model_spec(config), seed, [tokens], "cpu")[0]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_capacity_rule_drops_at_125_and_not_when_dropless():
    spec = model_spec(dict(MOE, port={"capacity_factor": 1.25}))
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(1))
    w = reference._load(weights.layer(spec, 3, 0, "cpu"), "fp32")
    dropped = reference.moe(x, w, spec, "fp32")
    full = reference.moe(x, w, dataclasses.replace(spec,
                                                   capacity_factor=4.0),
                         "fp32")
    assert spec.capacity(40) == 12
    assert not torch.allclose(dropped, full)


def test_program_and_reference_draw_the_same_weights():
    spec = model_spec(dict(MOE, port={"capacity_factor": 4.0}))
    p = weights.program_params(spec, 5, "cpu")
    lay = weights.layer(spec, 5, 1, "cpu")
    assert torch.equal(p["layers"][1]["mlp"]["wg"], lay["e_wg"])
    assert torch.equal(p["layers"][1]["attn"]["wo"]["w"], lay["wo"])
    emb = weights.embed(spec, 5, "cpu")
    assert torch.equal(p["embed"]["lm_head"], emb["head"].t())
    assert p["embed"]["lm_head"].t().is_contiguous()
    other = weights.program_params(spec, 6, "cpu")
    assert not torch.equal(other["layers"][1]["mlp"]["wg"], lay["e_wg"])
    weights.redraw(other, spec, 5)
    assert torch.equal(other["layers"][1]["mlp"]["wg"], lay["e_wg"])
    assert torch.equal(other["embed"]["tokens"], emb["tokens"])


def test_control_rounds_to_float8():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(2))
    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(3))
    exact = reference.mm(x, w, "fp32")
    w8 = reference._load({"w": w}, "fp8")["w"]
    low = reference.mm(x, w8, "fp8")
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2
