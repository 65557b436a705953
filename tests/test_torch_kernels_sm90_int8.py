"""The int8 products on the TMA + wgmma ring (``csrc/quantized_sm90.cu``).

``quantized_zero_stall_matmul`` runs int8 codes whose rows TMA can
address on the sm90 design: swap AB, int32 split-k partials summed by a
second kernel before the dequantising epilogue.
``quantized_grouped_zero_stall_matmul`` runs such codes on the same ring
walked persistently over the experts' tiles, with per-group scales.  On
the CPU this file holds what the wrappers decide in Python (the design
rule, the split plan, the persistent walk, the tiles and shared memory
of the design) and the arithmetic of int32 split-k: summing the partials
of whole k ranges and then scaling is bit-equal to the plain version and
to the JAX package's reference on the same numpy codes.  Tests marked
``gpu`` launch the kernels and skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import quantized_matmul_ref as j_quantized_matmul_ref
from repro.kernels.ref import \
    quantized_grouped_matmul_ref as j_quantized_grouped_matmul_ref
from repro_torch.kernels import zero_stall_matmul as zsm_mod
from repro_torch.kernels.grouped_matmul import grouped_blocks, grouped_walk
from repro_torch.kernels.quantized_matmul import (
    quantized_grouped_zero_stall_matmul, quantized_zero_stall_matmul)
from repro_torch.kernels.ref import (quantized_grouped_matmul_ref,
                                     quantized_matmul_ref)
from repro_torch.kernels.zero_stall_matmul import (select_design, sm90_rows,
                                                   split_plan)
from repro_torch.plan import KernelConfig
from repro_torch.quant import quantize, quantize_rows
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

SMS = 132                            # streaming multiprocessors of an H100
INT8 = torch.int8
BK = KernelConfig().matmul_kwargs(INT8)["bk"]      # the path's k tile
# (name, K, N) of the W8A8 projections of gemma-7b and olmoe-1b-7b
SHAPES = [("gemma wq/wk/wv", 3072, 4096), ("gemma attn wo", 4096, 3072),
          ("gemma mlp wi/wg", 3072, 24576), ("gemma mlp wo", 24576, 3072),
          ("olmoe wq/wk/wv/wo", 2048, 2048)]
GROUPED_BK = KernelConfig().matmul_kwargs(INT8, grouped=True)["bk"]
# (name, G, K, N) of olmoe-1b-7b's W8A8 expert banks; C = 1 row an
# expert at decode (4 slots), 20 at a 128-token prefill
BANKS = [("wi/wg", 64, 2048, 1024), ("wo", 64, 1024, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _codes(rng, M, K, N, lead=()):
    """int8 activation codes and row scales, K-major weight codes and
    column scales, from seeded numpy draws (the QTensor layout); ``lead``
    adds group dimensions."""
    x_q, x_s = quantize_rows(torch.from_numpy(
        rng.standard_normal(lead + (M, K), dtype=np.float32)))
    qw = quantize(torch.from_numpy(rng.standard_normal(lead + (K, N),
                                                       dtype=np.float32)))
    return x_q, qw.data, x_s, qw.scale


# ----------------------------------------------------------------------
# the design rule, the split plan, tiles and shared memory
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,K,N", SHAPES)
def test_main_path_int8_runs_sm90(name, K, N):
    """Every W8A8 projection of the main paths is TMA-legal int8."""
    assert select_design(INT8, K, N, True) == "sm90"


@pytest.mark.parametrize("case,want", [
    (dict(K=80, N=200), "sm90"), (dict(K=16, N=3), "sm90"),
    (dict(K=72, N=200), "ring"), (dict(K=45, N=29), "ring"),
    (dict(K=64, N=64, a_ptr=8), "ring"), (dict(K=64, N=64, b_ptr=4), "ring"),
])
def test_int8_design_rule(case, want):
    """int8 rows are TMA-legal at K % 16 == 0 from 16-byte aligned bases
    (72 is not); the K-major weight puts no condition on N."""
    assert select_design(INT8, trans_b=True, **case) == want


def test_path_k_tile_is_a_bf16_stage():
    """The path's int8 stage holds 256 codes of k: the 256 bytes of a
    bf16 stage of 128, a 32 KB weight tile at bn 128."""
    assert BK == 256
    assert 128 * BK == 128 * KernelConfig().resolved_bk(torch.bfloat16) * 2


@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("name,K,N,want", [
    ("gemma wq/wk/wv", 3072, 4096, (4, 3)),
    ("gemma attn wo", 4096, 3072, (4, 4)),
    ("gemma mlp wi/wg", 3072, 24576, (1, 12)),
    ("gemma mlp wo", 24576, 3072, (5, 20)),
    ("olmoe wq/wk/wv/wo", 2048, 2048, (8, 1)),
])
def test_int8_split_plan(name, K, N, want, M):
    """About 4 k splits for wq/wk/wv and attn wo, 5 for mlp wo, none for
    the 192-tile wi/wg, at decode and at a 128-token prefill: no second
    wave, every split a whole, non-empty number of 256-code stages."""
    splits, per = split_plan(M, N, K, 128, 128, BK, SMS)
    assert (splits, per) == want
    steps = -(-K // BK)
    assert (splits - 1) * per < steps <= splits * per
    tiles = -(-M // sm90_rows(M, 128)) * -(-N // 128)
    assert tiles * splits <= max(tiles, SMS)


@pytest.mark.parametrize("slots", [1, 2, 3, 4])
@pytest.mark.parametrize("M,bk", [(4, 128), (4, 256), (4, 512),
                                  (128, 128), (128, 256)])
def test_int8_sm90_shared_memory(M, bk, slots):
    """A stage is a bn x bk weight tile and a rows x bk activation tile of
    1-byte codes; the design takes what fits a Hopper block and raises
    on the rest."""
    rows = sm90_rows(M, 128)
    need = zsm_mod.sm90_smem_bytes(rows, 128, bk, slots, 1)
    assert need == 1024 + slots * ((128 + rows) * bk + 16)
    if need <= zsm_mod.SMEM_LIMIT:
        zsm_mod._check_sm90_config(M, 128, 128, bk, slots, INT8)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            zsm_mod._check_sm90_config(M, 128, 128, bk, slots, INT8)


@pytest.mark.parametrize("tiles", [(128, 128, 64), (128, 128, 192),
                                   (128, 128, 640), (128, 32, 128),
                                   (96, 128, 128)])
def test_int8_sm90_rejects_tiles_it_cannot_take(tiles):
    """bk must be whole 128-code TMA boxes, at most four."""
    bm, bn, bk = tiles
    with pytest.raises(ValueError, match=r"int8, sm90"):
        zsm_mod._check_sm90_config(4, bm, bn, bk, 2, INT8,
                                   "quantized_zero_stall_matmul")


def test_cpu_int8_counts_no_design():
    x_q, w, x_s, w_s = _codes(np.random.default_rng(0), 4, 80, 200)
    before = dict(quantized_zero_stall_matmul.launches_by_design)
    got = quantized_zero_stall_matmul(x_q, w, x_s, w_s)
    assert quantized_zero_stall_matmul.launches_by_design == before
    assert set(before) == {"sm90", "ring"}
    assert torch.equal(got, quantized_matmul_ref(x_q, w, x_s, w_s))


# ----------------------------------------------------------------------
# the grouped product: the design rule, the walk, the k tile
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,G,K,N", BANKS)
def test_grouped_int8_banks_run_sm90(name, G, K, N):
    """olmoe-1b-7b's int8 banks are TMA-legal (the K-major weight puts no
    condition on N, so any capacity C takes the sm90 design)."""
    assert select_design(INT8, K, N, True) == "sm90"


@pytest.mark.parametrize("case,want", [
    (dict(K=80, N=208), "sm90"), (dict(K=144, N=264), "sm90"),
    (dict(K=45, N=29), "ring"), (dict(K=72, N=208), "ring"),
    (dict(K=64, N=48, a_ptr=8), "ring"), (dict(K=64, N=48, b_ptr=24), "ring"),
])
def test_grouped_int8_design_rule(case, want):
    """The grouped int8 product takes the rule of the plain one: K % 16
    == 0 from 16-byte aligned bases runs sm90; a ragged K or a base off a
    16-byte line keeps the cp.async ring."""
    assert select_design(INT8, trans_b=True, **case) == want


@pytest.mark.parametrize("C,rows", [(1, 8), (20, 32)])
@pytest.mark.parametrize("name,G,K,N", BANKS)
def test_grouped_int8_walk_at_the_banks(name, G, K, N, C, rows):
    """At decode (C = 1) a block owns 8 activation rows, at a 128-token
    prefill (C = 20) 32; the 512 (wi/wg) or 1024 (wo) tiles go to 132
    persistent blocks, 3-8 tiles each, every tile once."""
    assert sm90_rows(C, 128) == rows
    tiles = G * -(-C // rows) * -(-N // 128)
    assert tiles == G * N // 128
    assert grouped_blocks(G, C, N, rows, 128, SMS) == SMS
    walk = grouped_walk(G, C, N, rows, 128, SMS)
    sizes = {len(block) for block in walk}
    assert sizes <= {tiles // SMS, -(-tiles // SMS)}
    assert sum(len(block) for block in walk) == tiles


@pytest.mark.parametrize("slots", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 20])
def test_grouped_int8_k_tile_is_a_bf16_stage(C, slots):
    """The grouped int8 default k tile is 256 codes, as the plain one's
    (a stage of a bf16 product's bytes: a 32 KB weight tile at bn 128),
    and it fits every ring depth phase 6 times at decode and prefill."""
    assert GROUPED_BK == BK == 256
    rows = sm90_rows(C, 128)
    need = zsm_mod.sm90_smem_bytes(rows, 128, GROUPED_BK, slots, 1)
    assert need == 1024 + slots * ((128 + rows) * 256 + 16) <= \
        zsm_mod.SMEM_LIMIT
    zsm_mod._check_sm90_config(C, 128, 128, GROUPED_BK, slots, INT8,
                               "quantized_grouped_zero_stall_matmul")


def test_cpu_grouped_int8_counts_no_design():
    x_q, w, x_s, w_s = _codes(np.random.default_rng(1), 3, 80, 208, (5,))
    before = dict(quantized_grouped_zero_stall_matmul.launches_by_design)
    launches = quantized_grouped_zero_stall_matmul.launches
    got = quantized_grouped_zero_stall_matmul(x_q, w, x_s, w_s)
    assert quantized_grouped_zero_stall_matmul.launches_by_design == before
    assert quantized_grouped_zero_stall_matmul.launches == launches
    assert set(before) == {"sm90", "ring"}
    assert torch.equal(got, quantized_grouped_matmul_ref(x_q, w, x_s, w_s))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_grouped_int8_epilogue_scales_per_group(out):
    """The kernel's epilogue reads a_scale[g * M + m] and b_scale[g * N +
    n]: the plain version with scales flattened that way, per group,
    equals the JAX reference on the same numpy codes (fp32 bit for bit)."""
    G, M, K, N = 5, 3, 80, 208
    x_q, w, x_s, w_s = _codes(np.random.default_rng(2), M, K, N, (G,))
    acc = x_q.to(torch.int32) @ w.to(torch.int32)
    a_flat, b_flat = x_s.reshape(-1), w_s.reshape(-1)
    g, m, n = torch.meshgrid(torch.arange(G), torch.arange(M),
                             torch.arange(N), indexing="ij")
    got = ((acc.float() * a_flat[g * M + m]) * b_flat[g * N + n]).to(out)
    assert torch.equal(got, quantized_grouped_matmul_ref(x_q, w, x_s, w_s,
                                                         out))
    want = j_quantized_grouped_matmul_ref(
        jnp.asarray(x_q.numpy()), jnp.asarray(w.contiguous().numpy()),
        jnp.asarray(x_s.numpy()), jnp.asarray(w_s.numpy()))
    if out == torch.float32:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# int32 split-k: the kernel's arithmetic, in plain PyTorch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("name,K,N", SHAPES)
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_int32_split_k_is_bit_equal(name, K, N, M, out):
    """The int32 partials of the plan's k ranges, summed in split order
    and then scaled once, give the bits of the plain version and of the
    JAX reference (32 of the N columns: the plan is the full shape's)."""
    splits, per = split_plan(M, N, K, 128, 128, BK, SMS)
    rng = np.random.default_rng(K + N + M)
    x_q, w, x_s, w_s = _codes(rng, M, K, 32)
    acc = torch.zeros(M, 32, dtype=torch.int32)
    for z in range(splits):
        k0, k1 = z * per * BK, min(K, (z + 1) * per * BK)
        acc += x_q[:, k0:k1].to(torch.int32) @ w[k0:k1].to(torch.int32)
    got = ((acc.to(torch.float32) * x_s) * w_s).to(out)
    assert torch.equal(got, quantized_matmul_ref(x_q, w, x_s, w_s, out))
    want = j_quantized_matmul_ref(jnp.asarray(x_q.numpy()),
                                  jnp.asarray(w.contiguous().numpy()),
                                  jnp.asarray(x_s.numpy()),
                                  jnp.asarray(w_s.numpy()))
    if out == torch.float32:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# on the card (skip here)
# ----------------------------------------------------------------------
def _ring(slots):
    return dict(slots=slots, variant="single" if slots == 1 else "dobu")


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("grid_order", ["ijk", "jik"])
@pytest.mark.parametrize("bk", [128, 256])
def test_int8_sm90_aligned_non_square_on_card(cuda, slots, grid_order, bk):
    """(4, 80, 200): the scales under swap AB (a row index mistaken for a
    column passes only at M = N), TMA boxes past every edge; fp32 and
    bf16 out bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x_q, x_s = quantize_rows(torch.randn(4, 80, device=cuda, generator=g))
    qw = quantize(torch.randn(80, 200, device=cuda, generator=g))
    for out in (torch.float32, torch.bfloat16):
        before = quantized_zero_stall_matmul.launches_by_design["sm90"]
        got = quantized_zero_stall_matmul(
            x_q, qw.data, x_s, qw.scale, bk=bk, grid_order=grid_order,
            out_dtype=out, **_ring(slots))
        assert quantized_zero_stall_matmul.launches_by_design["sm90"] \
            == before + 1
        assert torch.equal(got, quantized_matmul_ref(x_q, qw.data, x_s,
                                                     qw.scale, out))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 128])
def test_int8_sm90_split_k_on_card(cuda, M):
    """gemma-7b's mlp wo, 5 k splits: bit-equal to the plain version, and
    two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(1)
    K, N = 24576, 3072
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert split_plan(M, N, K, 128, 128, BK, sms)[0] > 1
    x_q, x_s = quantize_rows(torch.randn(M, K, device=cuda, generator=g))
    qw = quantize(torch.randn(K, N, device=cuda, generator=g))
    first = quantized_zero_stall_matmul(x_q, qw.data, x_s, qw.scale, bk=BK,
                                        out_dtype=torch.bfloat16)
    assert torch.equal(first, quantized_zero_stall_matmul(
        x_q, qw.data, x_s, qw.scale, bk=BK, out_dtype=torch.bfloat16))
    assert torch.equal(first, quantized_matmul_ref(x_q, qw.data, x_s,
                                                   qw.scale, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 20])
@pytest.mark.parametrize("name,G,K,N", BANKS)
def test_grouped_int8_banks_on_card(cuda, name, G, K, N, C):
    """The olmoe banks at decode and prefill capacity, with the path's
    tiles: the sm90 design, bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x_q, x_s = quantize_rows(torch.randn(G, C, K, device=cuda, generator=g))
    qw = quantize(torch.randn(G, K, N, device=cuda, generator=g))
    before = quantized_grouped_zero_stall_matmul.launches_by_design["sm90"]
    got = quantized_grouped_zero_stall_matmul(
        x_q, qw.data, x_s, qw.scale, out_dtype=torch.bfloat16,
        **KernelConfig().matmul_kwargs(INT8, grouped=True))
    assert quantized_grouped_zero_stall_matmul.launches_by_design["sm90"] \
        == before + 1
    assert torch.equal(got, quantized_grouped_matmul_ref(
        x_q, qw.data, x_s, qw.scale, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("bk", [128, 256])
@pytest.mark.parametrize("shape", [(5, 3, 80, 208), (3, 130, 144, 264)])
def test_grouped_int8_ragged_on_card(cuda, shape, bk, slots):
    """K past a stage, N past a tile, M past 128 rows: rank-3 boxes
    zero-fill inside their group; fp32 and bf16 out bit-equal."""
    G, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    x_q, x_s = quantize_rows(torch.randn(G, M, K, device=cuda, generator=g))
    qw = quantize(torch.randn(G, K, N, device=cuda, generator=g))
    for out in (torch.float32, torch.bfloat16):
        before = quantized_grouped_zero_stall_matmul.launches_by_design["sm90"]
        got = quantized_grouped_zero_stall_matmul(
            x_q, qw.data, x_s, qw.scale, bk=bk, out_dtype=out, **_ring(slots))
        assert quantized_grouped_zero_stall_matmul.launches_by_design[
            "sm90"] == before + 1
        assert torch.equal(got, quantized_grouped_matmul_ref(
            x_q, qw.data, x_s, qw.scale, out))


@pytest.mark.gpu
def test_grouped_int8_off_a_line_takes_the_ring_on_card(cuda):
    """Codes that start 8 bytes off a 16-byte line cannot be TMA'd: the
    ring runs them, bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x_q, x_s = quantize_rows(torch.randn(5, 3, 64, device=cuda, generator=g))
    qw = quantize(torch.randn(5, 64, 48, device=cuda, generator=g))
    off = torch.empty(x_q.numel() + 8, dtype=INT8, device=cuda)[8:]
    off = off.view(x_q.shape)
    off.copy_(x_q)
    before = quantized_grouped_zero_stall_matmul.launches_by_design["ring"]
    got = quantized_grouped_zero_stall_matmul(off, qw.data, x_s, qw.scale)
    assert quantized_grouped_zero_stall_matmul.launches_by_design["ring"] \
        == before + 1
    assert torch.equal(got, quantized_grouped_matmul_ref(x_q, qw.data, x_s,
                                                         qw.scale))
