"""The SSM and hybrid families across ranks on the CPU: ``ShardedEngine``
of reduced mamba2-130m and zamba2-2.7b in fp32 on the kernel path, on
(1, 4) and then (2, 2) in one world of four ``gloo`` ranks, as
``test_torch_multirank_families.py`` runs the vlm and encdec families.
On every rank the tokens of the port's one-rank engine on JAX's
weights, and those are JAX's unsharded engine's; the ``conv`` and
``ssm`` states (and zamba2's shared-block ``k`` and ``v``) placed by
``cache_shardings``, as JAX's rules give: on (2, 2) the mamba ``conv``
state's name ends like a KV leaf's, so its stacked layer dims shard, and
each decode step writes a layer's state back into the rank's own shard
(``sharding.write_layers``).  DTensor plans every SSM op here: nothing
is replicated for want of a plan.
"""

import pytest

import torch_ranks
from torch_rank_refs import SHAPES, check_world, serve_references
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_sharded_engine_serves_ssm_and_hybrid_across_ranks(arch, tmp_path):
    ref = serve_references(arch, False, tmp_path)
    outs = torch_ranks.world(torch_ranks.family_engine, 4, tmp_path, arch,
                             ref["npz"], False, SHAPES, timeout=240)
    check_world(outs, ref)
