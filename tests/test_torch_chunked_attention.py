"""The reference's chunked attention on the port's plain path.

* ``layers._gqa_chunked`` and the merged-head ``layers._mha_chunked``
  against JAX's ``_gqa_chunked`` and ``_mha_chunked`` called directly
  (B 1, S = T = 2048, H 4 over 4 and 2 KV heads, D 16, causal and not):
  outputs and the gradients of q, k and v within 2e-5 in fp32.
* ``layers._gqa_full`` on the ``"torch"`` backend takes the chunked
  forms exactly where JAX's rule fires (no ``lengths``, S x T above
  1024 x 1024, S and T multiples of 1024), the merged-head one under a
  mesh; everywhere else it runs the whole-matrix einsums of the tree
  before the chunked forms, bit for bit.
* The dry run of a reduced prefill past the rule counts JAX's FLOPs:
  every (q block, kv block) pair is computed, the masked ones too, as
  JAX's scans compute them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import Ctx
from repro_torch.models import layers as L
from repro_torch.plan import as_plan
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5


def _qkv(S, T, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, S, H, D), dtype=np.float32),
            rng.standard_normal((1, T, KV, D), dtype=np.float32),
            rng.standard_normal((1, T, KV, D), dtype=np.float32))


def _forms(form, kv):
    """(port function, JAX function, K/V heads the function takes)."""
    if form == "gqa":
        return L._gqa_chunked, JL._gqa_chunked, kv
    return L._mha_chunked, JL._mha_chunked, 4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("form,kv", [("gqa", 4), ("gqa", 2), ("mha", 4)])
def test_chunked_forms_match_jax_forward_and_gradient(form, kv, causal):
    port, ref, heads = _forms(form, kv)
    q, k, v = _qkv(2048, 2048, 4, heads, 16)
    ct = np.random.default_rng(1).standard_normal(q.shape, dtype=np.float32)

    def jloss(q, k, v):
        return jnp.sum(ref(q, k, v, causal=causal) * ct)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(ref(jq, jk, jv, causal=causal))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port(*xs, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    (out * torch.from_numpy(ct)).sum().backward()
    for x, g, name in zip(xs, jgrads, "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")


def test_q_blocks_are_rematerialised_in_the_backward(monkeypatch):
    """Each q block runs again in the backward (JAX's ``nothing_saveable``
    checkpoint on the outer scan's body): forward two blocks, backward
    two more."""
    calls = []
    block = L._online_block

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return block(*a, **kw)

    monkeypatch.setattr(L, "_online_block", counted)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(2048, 2048, 4, 2, 16))
    out = L._gqa_chunked(q, k, v, causal=True)
    assert len(calls) == 2
    out.sum().backward()
    assert len(calls) == 4
    with torch.no_grad():
        L._gqa_chunked(q, k, v, causal=True)
    assert len(calls) == 6


@pytest.mark.parametrize("S,T,lengths,chunked", [
    (2048, 2048, False, True),
    (1024, 2048, False, True),
    (1024, 1024, False, False),      # S x T = 1024^2: not above the rule
    (1536, 2048, False, False),      # S not a multiple of 1024
    (2048, 2048, True, False),       # lengths given
])
@pytest.mark.parametrize("merged", [False, True])
def test_the_rule_and_bit_equality_below_it(monkeypatch, S, T, lengths,
                                            chunked, merged):
    taken = []
    for name in ("_gqa_chunked", "_mha_chunked"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _n=name, _f=fn, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    q, k, v = (torch.from_numpy(a) for a in _qkv(S, T, 4, 2, 16))
    lens = torch.tensor([S - 5], dtype=torch.int32) if lengths else None
    ctx = (Ctx(plan="torch", dtype=torch.float32,
               mesh=make_mesh_compat((1, 1), ("data", "model"),
                                     device="cpu")) if merged else None)
    with torch.no_grad():
        got = L._gqa_full(q, k, v, causal=True, config=as_plan("torch"),
                          lengths=lens, ctx=ctx)
    if chunked:
        assert taken == ["_mha_chunked" if merged else "_gqa_chunked"]
        return
    assert taken == []
    if merged:      # the parent tree's merged-head form: K, V repeated
        k, v = (torch.repeat_interleave(t, 2, dim=2) for t in (k, v))
    with torch.no_grad():
        want = L._gqa_full_grouped(q, k, v, lens, None, causal=True)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the dry run's FLOPs where the chunked forms fire
# ----------------------------------------------------------------------
_CELL = """
import json, sys
side, arch, seq, batch = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    int(sys.argv[4])
mesh = tuple(int(n) for n in sys.argv[5].split("x"))
if side == "jax":
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun as d
    from repro.launch.mesh import make_mesh_compat
    d.get_config = lambda a: get_config(a, reduced=True)
    d.make_production_mesh = lambda multi_pod: make_mesh_compat(
        mesh, ("data", "model"))
else:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as d
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import layers
    d.get_config = lambda a, reduced=False: get_config(a, reduced=True)
    d.make_production_mesh = lambda multi_pod, device=None: \\
        make_mesh_compat(mesh, ("data", "model"), device="meta")
    if side == "whole":         # the rule off: the whole score matrix
        layers._ATTN_CHUNK_ELEMS = 1 << 62
d.SKIP = {}
d.SHAPES = {"x": ShapeSpec("x", seq, batch, "prefill")}
row = d.run_cell(arch, "x", multi_pod=False)
assert row["status"] == "ok", row
print("CELL", json.dumps({"flops": row["hlo_gflops"] * 1e9}))
"""


def _cell_flops(side, arch, mesh, tmp_path) -> float:
    """The FLOPs of a reduced ``arch`` prefill cell at S = 2048, batch 2,
    on ``mesh`` through JAX's ``run_cell`` (``side`` "jax": host devices,
    compiled) or the port's ("torch", "whole": the chunk rule off; a
    fake world)."""
    n = int(np.prod([int(x) for x in mesh.split("x")]))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "tune.json"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    out = subprocess.run([sys.executable, "-c", _CELL, side, arch, "2048",
                          "2", mesh], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.split("CELL", 1)[1])["flops"]


@pytest.mark.parametrize("arch", ["gemma-7b", "llava-next-34b"])
def test_dry_run_flops_of_a_chunked_prefill(arch, tmp_path):
    """A reduced prefill at S = 2048, where the chunked forms fire: on one
    device the port's dry run counts JAX's FLOPs (every (q block, kv
    block) pair, the masked ones too, as JAX's scans count them); on a
    (2, 4) mesh the chunked forms count what the whole score matrix
    counts (llava's 4 heads over 2 KV heads take the grouped form, as
    gemma's 4 over 4)."""
    assert _cell_flops("torch", arch, "1x1", tmp_path) == \
        _cell_flops("jax", arch, "1x1", tmp_path)
    assert _cell_flops("torch", arch, "2x4", tmp_path) == \
        _cell_flops("whole", arch, "2x4", tmp_path)
