"""``Checkpointer.save`` across ranks gathers one leaf at a time.

A world of four ``gloo`` ranks places reduced gemma-7b's params on
(2, 2) and saves them: the checkpoint is byte for byte the one a single
process writes of the same params, and no rank ever holds more than one
gathered leaf (each ``DTensor.full_tensor`` result is counted while it
is alive), where gathering every leaf before the first host copy held
the whole state at once.
"""

import torch

import torch_ranks
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.tree import leaves
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)


def test_four_rank_save_is_the_one_rank_save_a_leaf_at_a_time(tmp_path):
    params = build_model(get_config("gemma-7b", reduced=True)).init(
        seed=0, dtype=torch.float32, device="cpu")
    one, four = tmp_path / "one", tmp_path / "four"
    Checkpointer(str(one), keep=1).save(10, {"params": params},
                                        blocking=True)
    outs = torch_ranks.world(torch_ranks.save_one_leaf_at_a_time, 4,
                             tmp_path, str(four))
    n = len(leaves(params))
    for o in outs:
        assert o["gathers"] == n
        assert o["peak"] == 1
    want = sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file())
    got = sorted(p.relative_to(four) for p in four.rglob("*")
                 if p.is_file())
    assert got == want and len(want) == n + 1      # the leaves, manifest
    for rel in want:
        assert (four / rel).read_bytes() == (one / rel).read_bytes(), rel
