"""The kernels on local shards, on the card: kernel 1 (the zero-stall
matmul) on column-, row- and batch-sharded DTensor operands and kernel 2
(flash attention) through ``sharding.map_heads``, in a two-rank world on
one card (the ranks share it over gloo), each against its plain version
on the same global operands.  Skips without a CUDA device; the CPU half
of the same world runs in ``test_torch_multirank.py``."""

import pytest
import torch

import torch_ranks
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_kernels_run_on_each_ranks_shards(cuda, tmp_path):
    outs = torch_ranks.world(torch_ranks.ops_on_shards, 2, tmp_path,
                             "cuda", device=None, timeout=300)
    for o in outs:
        # bf16 kernels against the plain product: bf16 rounding of the
        # outputs and of a partial sum's two halves
        tol = 2e-2 * o["scale"]
        assert o["column"][0] <= tol and o["column"][1] == ["R", "S(1)"]
        assert o["row"][0] <= tol and o["row"][1] == ["R", "P(sum)"]
        assert o["batch"][0] <= tol and o["batch"][1] == ["S(0)", "R"]
        assert o["attention"][0] <= 2e-2
        assert o["attention"][1] == ["R", "S(2)"]
        made = {k: v for k, v in o["launches"].items() if "." not in k}
        assert made == {"zero_stall_matmul": 3, "flash_attention": 1}, made
