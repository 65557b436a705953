"""The kernels on local shards, on the card: kernel 1 (the zero-stall
matmul) on column-, row- and batch-sharded DTensor operands, kernel 2
(flash attention) through ``sharding.map_heads``, and kernels 4, 5 and 6
(the int8, grouped and int8 grouped products) on their sharded operands,
in a two-rank world on one card (the ranks share it over gloo), each
against its plain version on the same global operands.  Skips without
a CUDA device; the CPU halves of the same worlds run in
``test_torch_multirank.py`` and ``test_torch_multirank_quant_moe.py``."""

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
        # outputs; a bf16 partial sum is summed in fp32 at once and
        # rounded once, so the row split comes back reduced
        tol = 2e-2 * o["scale"]
        assert o["column"][0] <= tol and o["column"][1] == ["R", "S(1)"]
        assert o["row"][0] <= tol and o["row"][1] == ["R", "R"]
        assert o["batch"][0] <= tol and o["batch"][1] == ["S(0)", "R"]
        assert o["attention"][0] <= 2e-2
        assert o["attention"][1] == ["R", "S(2)"]
        made = {k: v for k, v in o["launches"].items() if "." not in k}
        assert made == {"zero_stall_matmul": 3, "flash_attention": 1}, made


def test_int8_and_grouped_kernels_run_on_each_ranks_shards(cuda, tmp_path):
    """Kernels 4, 5 and 6 on the local shards of column-, row- and
    batch-sharded int8 products, group-, contraction- and bank-sharded
    grouped products and group- and contraction-sharded int8 grouped
    products, each against its plain version on the global operands."""
    outs = torch_ranks.world(torch_ranks.int8_and_grouped_ops_on_shards, 2,
                             tmp_path, "cuda", device=None, timeout=300)
    # bf16 outputs: a partial sum is summed in fp32 at once and rounded
    # once, so the contraction splits come back reduced
    want = {"int8_column": ("int8", ["R", "S(1)"]),
            "int8_row": ("int8", ["R", "R"]),
            "int8_batch": ("int8", ["S(0)", "R"]),
            "grouped_groups": ("grouped", ["R", "S(0)"]),
            "grouped_contraction": ("grouped", ["R", "R"]),
            "grouped_bank_replicated": ("grouped", ["R", "S(0)"]),
            "int8_grouped_groups": ("int8_grouped", ["R", "S(0)"]),
            "int8_grouped_row": ("int8_grouped", ["R", "R"])}
    for o in outs:
        for name, (kind, placements) in want.items():
            err, got = o[name]
            # bf16 outputs of exact int32 or fp32 sums: bf16 rounding
            assert err <= 2e-2 * o["scale"][kind], name
            assert got == placements, name
        made = {k: v for k, v in o["launches"].items() if "." not in k}
        assert made == {"quantized_zero_stall_matmul": 3,
                        "grouped_zero_stall_matmul": 3,
                        "quantized_grouped_zero_stall_matmul": 2}, made
