"""W8A8 and MoE across ranks on the CPU: worlds of four ``gloo`` ranks,
one process a rank (``tests/torch_ranks.py``), held against the port's
one-rank engine and JAX's unsharded ``ServeEngine``.

* Kernels 4, 5 and 6's entry points (``ops.quantized_matmul``,
  ``grouped_matmul``, ``quantized_grouped_matmul``) on DTensor operands
  run each rank's local shards (their plain versions here; the kernels
  on the card in ``test_torch_multirank_card.py``) and wrap them back
  with DTensor's ``mm`` / ``bmm`` placements, within 1e-5 of the global
  product's scale.  The row-parallel int8 cases give each rank's slice
  of a row a different absmax: a scale taken over the local slice
  alone would miss by the int8 rounding, far past 1e-5.
* ``ShardedEngine`` of reduced gemma-7b in W8A8 and reduced olmoe-1b-7b
  in fp32 and in W8A8 on (1, 4) and then (2, 2) in one world, on the
  kernel path (``Ctx(plan="auto")`` / ``KernelConfig(quant="int8")``):
  on every rank the tokens of the port's one-rank engine on the same
  weights, and those are JAX's unsharded engine's; params sharded for
  real (a QTensor's codes and scales by the rules' children 0 and 1,
  which JAX's rules replicate), no decode graph; the MoE dispatch and
  combine replicated and counted.
"""

import pytest

import torch_ranks
from torch_rank_refs import SHAPES, check_world, serve_references
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

@pytest.mark.parametrize("arch,quant", [("gemma-7b", True),
                                        ("olmoe-1b-7b", False),
                                        ("olmoe-1b-7b", True)],
                         ids=["gemma-w8a8", "olmoe-fp32", "olmoe-w8a8"])
def test_sharded_engine_serves_w8a8_and_moe_across_ranks(arch, quant,
                                                         tmp_path):
    ref = serve_references(arch, quant, tmp_path)
    outs = torch_ranks.world(torch_ranks.family_engine, 4, tmp_path, arch,
                             ref["npz"], quant, SHAPES, timeout=240)
    moe = ("moe.dispatch", "moe.combine") if arch == "olmoe-1b-7b" else ()
    check_world(outs, ref, replicated=moe, required=moe)


def test_int8_and_grouped_entry_points_on_local_shards(tmp_path):
    outs = torch_ranks.world(torch_ranks.int8_and_grouped_ops_on_shards, 2,
                             tmp_path, "cpu")
    want = {"int8_column": ("int8", ["R", "S(1)"]),
            "int8_row": ("int8", ["R", "P(sum)"]),
            "int8_batch": ("int8", ["S(0)", "R"]),
            "grouped_groups": ("grouped", ["R", "S(0)"]),
            "grouped_contraction": ("grouped", ["R", "P(sum)"]),
            "grouped_bank_replicated": ("grouped", ["R", "S(0)"]),
            "int8_grouped_groups": ("int8_grouped", ["R", "S(0)"]),
            "int8_grouped_row": ("int8_grouped", ["R", "P(sum)"])}
    for o in outs:
        assert o["launches"] == {}
        for name, (kind, placements) in want.items():
            err, got = o[name]
            assert err <= 1e-5 * o["scale"][kind], name
            assert got == placements, name
