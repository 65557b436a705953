"""The vlm and encdec families across ranks on the CPU: ``ShardedEngine``
of reduced llava-next-34b (each request with its ``frontend_tokens``
patch positions, the image path run inside the engine's gathered
prefill) and seamless-m4t-large-v2 (each request with its source frames,
``enc_len`` 12, the cross cache written at admission) in fp32 on the
kernel path, on (1, 4) and then (2, 2) in one world of four ``gloo``
ranks.  On every rank the tokens of the port's one-rank engine on JAX's
weights, and those are JAX's unsharded engine's; params and caches
sharded for real (``k``, ``v``, ``cross_k`` and ``cross_v`` by
``cache_shardings``), no decode graph.  What DTensor cannot plan runs
replicated and counted (``ReplicateOnGap``): only llava's ``view`` on
(1, 4), whose two KV heads do not divide the 'model' axis.  The SSM and
hybrid families: ``test_torch_multirank_ssm.py``.
"""

import pytest

import torch_ranks
from torch_rank_refs import SHAPES, check_world, serve_references
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-large-v2"])
def test_sharded_engine_serves_vlm_and_encdec_across_ranks(arch, tmp_path):
    ref = serve_references(arch, False, tmp_path)
    outs = torch_ranks.world(torch_ranks.family_engine, 4, tmp_path, arch,
                             ref["npz"], False, SHAPES, timeout=240)
    check_world(outs, ref, replicated=("view.default",)
                if arch == "llava-next-34b" else ())
