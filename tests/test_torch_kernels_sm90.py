"""The Hopper designs of the matmul and flash-attention wrappers.

The bf16 matmul of one product and of G groups runs a TMA + wgmma ring
(``csrc/zero_stall_sm90.cu``): split-k for one product, a persistent
walk over the groups' tiles for the grouped one; bf16 flash attention
runs on the tensor cores; fp32 and shapes TMA cannot address keep the
earlier designs.  What decides the design, the split-k plan, the
persistent walk, the tiles each design takes and the shared-memory
formulas are plain Python and are held here on the CPU; tests marked
``gpu`` launch the kernels and skip without a card.  Parity of the plain
versions with the JAX package is held in ``tests/test_torch_kernels.py``
and ``tests/test_torch_moe.py``; the int8 design in
``tests/test_torch_kernels_sm90_int8.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import zero_stall_matmul as zsm_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import (grouped_blocks,
                                                grouped_walk,
                                                grouped_zero_stall_matmul)
from repro_torch.kernels.ref import (flash_attention_ref, grouped_matmul_ref,
                                     matmul_ref)
from repro_torch.kernels.zero_stall_matmul import (select_design, sm90_rows,
                                                   split_plan,
                                                   zero_stall_matmul)
from repro_torch.plan import KernelConfig
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

BF16_TOL = 2e-2
SMS = 132                            # streaming multiprocessors of an H100
GEMMA = dict(d=3072, qkv=4096, ff=24576, V=256000)
OLMOE = dict(d=2048, V=50304, E=64, ff=1024)
# (name, K, N) of an olmoe-1b-7b expert bank; C = 1 row an expert at
# decode (4 slots), 20 at a 128-token prefill
EXPERTS = [("wi/wg", OLMOE["d"], OLMOE["ff"]), ("wo", OLMOE["ff"], OLMOE["d"])]
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# matmul: which design runs a product
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case,want", [
    (dict(dtype=BF16, K=3072, N=4096, trans_b=False), "sm90"),
    (dict(dtype=BF16, K=3072, N=256000, trans_b=True), "sm90"),
    (dict(dtype=BF16, K=72, N=200, trans_b=False), "sm90"),
    (dict(dtype=BF16, K=72, N=203, trans_b=True), "sm90"),
    (dict(dtype=torch.float32, K=3072, N=4096, trans_b=False), "ring"),
    (dict(dtype=BF16, K=45, N=32, trans_b=False), "ring"),
    (dict(dtype=BF16, K=64, N=29, trans_b=False), "ring"),
    (dict(dtype=BF16, K=64, N=64, trans_b=False, a_ptr=8), "ring"),
    (dict(dtype=BF16, K=64, N=64, trans_b=True, b_ptr=1026), "ring"),
])
def test_select_design_rule(case, want):
    """bf16 with TMA-legal rows -> sm90; fp32, ragged or misaligned bf16
    -> the cp.async ring.  The grouped wrapper takes the same rule (see
    test_grouped_launch_stays_on_the_ring_on_card)."""
    assert select_design(**case) == want


@pytest.mark.parametrize("M,bm,rows", [(1, 128, 8), (4, 128, 8), (9, 128, 16),
                                       (96, 128, 128), (128, 128, 128),
                                       (300, 128, 128), (4, 8, 8),
                                       (100, 32, 32)])
def test_sm90_rows(M, bm, rows):
    assert sm90_rows(M, bm) == rows


def _decode_shapes():
    g, o = GEMMA, OLMOE
    return [("gemma wq/wk/wv", g["d"], g["qkv"]),
            ("gemma attn wo", g["qkv"], g["d"]),
            ("gemma mlp wi/wg", g["d"], g["ff"]),
            ("gemma mlp wo", g["ff"], g["d"]),
            ("olmoe wq/wk/wv/wo", o["d"], o["d"])]


@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("name,K,N", _decode_shapes())
def test_split_plan_fills_the_card(name, K, N, M):
    """Every gemma-7b and olmoe-1b-7b projection at decode (M = 4) and at
    a 128-token prefill gets at least 0.9 x 132 blocks and no second
    wave, each split a whole, non-empty number of k stages."""
    bm, bn, bk = 128, 128, 128
    splits, per = split_plan(M, N, K, bm, bn, bk, SMS)
    tiles = -(-M // sm90_rows(M, bm)) * -(-N // bn)
    steps = -(-K // bk)
    blocks = tiles * splits
    assert (splits - 1) * per < steps <= splits * per
    if tiles < SMS:
        assert 0.9 * SMS <= blocks <= SMS, (name, tiles, splits)
    else:
        assert splits == 1


@pytest.mark.parametrize("V,d", [(GEMMA["V"], GEMMA["d"]),
                                 (OLMOE["V"], OLMOE["d"])])
@pytest.mark.parametrize("M", [1, 4])
def test_split_plan_leaves_the_lm_head_whole(V, d, M):
    assert split_plan(M, V, d, 128, 128, 128, SMS) == (1, -(-d // 128))


@pytest.mark.parametrize("K,bk,sms", [(72, 64, 132), (72, 128, 132),
                                      (192, 64, 2), (24576, 128, 7),
                                      (64, 64, 500)])
def test_split_plan_splits_whole_stages(K, bk, sms):
    splits, per = split_plan(4, 200, K, 128, 128, bk, sms)
    steps = -(-K // bk)
    assert 1 <= splits <= max(1, sms // 2) and per >= 1
    assert (splits - 1) * per < steps <= splits * per


# ----------------------------------------------------------------------
# matmul: tiles and shared memory of the sm90 design
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tiles", [(96, 128, 128), (128, 256, 128),
                                   (128, 32, 128), (128, 128, 96),
                                   (128, 128, 32), (128, 128, 320),
                                   (256, 128, 128)])
def test_sm90_rejects_tiles_it_cannot_take(tiles):
    bm, bn, bk = tiles
    with pytest.raises(ValueError, match="sm90"):
        zsm_mod._check_sm90_config(4, bm, bn, bk, 2)


@pytest.mark.parametrize("slots", [1, 2, 3, 4])
def test_sm90_default_tiles_fit_at_decode(slots):
    """The path's tiles (128, 128, 128) fit at M = 4 at every ring depth
    phase 6 times; the same four stages of 128 activation rows do not."""
    zsm_mod._check_sm90_config(4, 128, 128, 128, slots)
    need = zsm_mod.sm90_smem_bytes(8, 128, 128, slots)
    assert need == 1024 + slots * ((128 + 8) * 128 * 2 + 16)
    assert need <= zsm_mod.SMEM_LIMIT


def test_sm90_shared_memory_budget_follows_the_rows():
    zsm_mod._check_sm90_config(128, 128, 128, 128, 3)
    with pytest.raises(ValueError, match="shared memory"):
        zsm_mod._check_sm90_config(128, 128, 128, 128, 4)
    assert zsm_mod.sm90_smem_bytes(128, 128, 256, 1) <= zsm_mod.SMEM_LIMIT


def test_cpu_matmul_counts_no_design():
    a = torch.randn(4, 64).to(BF16)
    b = torch.randn(64, 32).to(BF16)
    before = dict(zero_stall_matmul.launches_by_design)
    got = zero_stall_matmul(a, b)
    assert zero_stall_matmul.launches_by_design == before
    assert set(before) == {"sm90", "ring"}
    torch.testing.assert_close(got, matmul_ref(a, b))


# ----------------------------------------------------------------------
# grouped matmul: the design, the persistent walk and its memory
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,K,N", EXPERTS)
def test_grouped_expert_banks_run_sm90(name, K, N):
    """olmoe-1b-7b's bf16 expert banks are TMA-legal (at any capacity C:
    the rule reads K, N and the bases); fp32 banks and a ragged K stay
    on the ring."""
    assert select_design(BF16, K, N, False) == "sm90"
    assert select_design(torch.float32, K, N, False) == "ring"
    assert select_design(BF16, K - 3, N, False) == "ring"


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("C", [1, 20])
@pytest.mark.parametrize("name,K,N", EXPERTS)
def test_grouped_walk_covers_every_tile_once(name, K, N, C, sms):
    """The persistent blocks (one per SM) walk every (g, i, j) tile of
    the 64 experts exactly once, each block in the g-major order, and no
    block takes more than one tile beyond another."""
    G, rows = OLMOE["E"], sm90_rows(C, 128)
    walk = grouped_walk(G, C, N, rows, 128, sms)
    tiles = G * -(-C // rows) * -(-N // 128)
    assert len(walk) == grouped_blocks(G, C, N, rows, 128, sms) \
        == min(sms, tiles)
    flat = [t for block in walk for t in block]
    assert len(flat) == len(set(flat)) == tiles
    assert set(flat) == {(g, i, j) for g in range(G)
                         for i in range(-(-C // rows))
                         for j in range(-(-N // 128))}
    assert all(block == sorted(block) for block in walk)
    sizes = [len(block) for block in walk]
    assert max(sizes) - min(sizes) <= 1


def test_grouped_walk_of_few_tiles_is_one_block_a_tile():
    assert grouped_walk(2, 3, 100, 8, 64, 132) == [
        [(0, 0, 0)], [(0, 0, 1)], [(1, 0, 0)], [(1, 0, 1)]]


@pytest.mark.parametrize("slots", [1, 2, 3, 4])
@pytest.mark.parametrize("C", [1, 20])
def test_grouped_sm90_tiles_fit(C, slots):
    """The path's tiles (128, 128, 128) at decode (8 rows) and prefill
    (32 rows) fit every ring depth phase 6 times."""
    rows = sm90_rows(C, 128)
    assert rows == (8 if C == 1 else 32)
    zsm_mod._check_sm90_config(C, 128, 128, 128, slots)
    need = zsm_mod.sm90_smem_bytes(rows, 128, 128, slots)
    assert need == 1024 + slots * ((128 + rows) * 128 * 2 + 16)


def test_cpu_grouped_counts_no_design():
    a = torch.randn(3, 2, 64).to(BF16)
    b = torch.randn(3, 64, 32).to(BF16)
    before = dict(grouped_zero_stall_matmul.launches_by_design)
    got = grouped_zero_stall_matmul(a, b)
    assert grouped_zero_stall_matmul.launches_by_design == before
    assert set(before) == {"sm90", "ring"}
    torch.testing.assert_close(got, grouped_matmul_ref(a, b))


# ----------------------------------------------------------------------
# flash attention: the tensor-core design's head dims, tiles and memory
# ----------------------------------------------------------------------
def test_flash_design_follows_dtype():
    assert fa_mod.design(BF16) == "tensor_core"
    assert fa_mod.design(torch.float32) == "cuda_core"
    assert set(flash_attention.launches_by_design) == {"tensor_core",
                                                       "cuda_core"}


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("bq", [16, 32, 64])
def test_flash_tc_tiles_and_shared_memory(D, bq):
    for bkv in (16, 32, 64):
        if bkv * D > 8192:
            with pytest.raises(ValueError, match="register"):
                fa_mod.check_tc_tiles(D, bq, bkv)
            continue
        fa_mod.check_tc_tiles(D, bq, bkv)
        need = fa_mod.smem_bytes(D, bq, bkv, BF16)
        assert need == 2 * (D + 8) * (bq + 4 * bkv) <= fa_mod.SMEM_LIMIT


@pytest.mark.parametrize("D", [8, 48, 96, 512])
def test_flash_tc_rejects_other_head_dims(D):
    with pytest.raises(ValueError, match=r"\(16, 32, 64, 80, 128, 256\)"):
        fa_mod.check_tc_tiles(D, 32, 32)


@pytest.mark.parametrize("bq", [16, 32, 64])
def test_flash_tc_takes_zamba2_head_dim(bq):
    """zamba2-2.7b's head dim, 2560 / 32 = 80: five k16 steps, a
    160-byte row padded to 176 bytes, every kv tile within the register
    budget; the serving prefill's tiles (32, 32) at S = 128."""
    for bkv in (16, 32, 64):
        fa_mod.check_tc_tiles(80, bq, bkv)
        assert fa_mod.smem_bytes(80, bq, bkv, BF16) == 176 * (bq + 4 * bkv)
    assert fa_mod.fit_tiles(BF16, 128, 128, 32, 32) == (32, 32)
    assert fa_mod.smem_bytes(80, 64, 64, BF16) == 56320


@pytest.mark.parametrize("Skv", [12, 128])
def test_flash_tiles_at_one_query_row(Skv):
    """Encdec cross-attention at decode: one query row a slot against the
    encoder's keys, non-causal.  The bf16 design takes one 16-row q tile
    (15 rows masked by q_lens = 1), head dim 64 (seamless: 1024 / 16) is
    instantiated, and the tiles fit; fp32 takes a 1-row tile."""
    bq, bkv = fa_mod.fit_tiles(BF16, 1, Skv, 32, 32)
    assert (bq, bkv) == (16, min(32, -(-Skv // 16) * 16))
    fa_mod.check_tc_tiles(64, bq, bkv)
    assert fa_mod.smem_bytes(64, bq, bkv, BF16) == 144 * (16 + 4 * bkv)
    assert fa_mod.fit_tiles(torch.float32, 1, Skv, 32, 32) == (1, min(32,
                                                                   Skv))


def test_ops_attention_at_one_query_row_passes_lengths(monkeypatch):
    """Sq = 1 is ragged against the 16-row tile: ops.attention hands the
    kernel device-side q_lens = 1 and kv_lens = Skv (no host read, so the
    call can be captured in a CUDA graph), and on the CPU the plain
    version gives the reference's non-causal rows."""
    seen = []

    def spy(q, k, v, **kw):
        seen.append({n: kw[n] for n in ("q_lens", "kv_lens", "bq", "bkv",
                                        "causal")})
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(ops, "_flash", spy)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((4, 16, 1, 64),
                                             dtype=np.float32)).to(BF16)
    k = torch.from_numpy(rng.standard_normal((4, 16, 12, 64),
                                             dtype=np.float32)).to(BF16)
    got = ops.attention(q, k, k, causal=False, config=KernelConfig())
    (kw,) = seen
    assert (kw["bq"], kw["bkv"], kw["causal"]) == (16, 16, False)
    assert kw["q_lens"].tolist() == [1] * 4
    assert kw["kv_lens"].tolist() == [12] * 4
    torch.testing.assert_close(got, flash_attention_ref(q, k, k,
                                                        causal=False))


@pytest.mark.parametrize("bq,bkv", [(8, 32), (32, 8), (128, 32), (48, 32),
                                    (32, 128)])
def test_flash_tc_rejects_other_tiles(bq, bkv):
    with pytest.raises(ValueError, match="tiles"):
        fa_mod.check_tc_tiles(128, bq, bkv)


def test_flash_fp32_shared_memory_formula_is_unchanged():
    assert fa_mod.smem_bytes(256, 32, 32) == 4 * (
        32 * 257 * 2 + 32 * 256 * 2 + 32 * 32 + 3 * 32)
    assert fa_mod.smem_bytes(256, 32, 32, BF16) < fa_mod.smem_bytes(256, 32,
                                                                    32)


@pytest.mark.parametrize("dtype,S,T,want", [
    (BF16, 5, 5, (16, 16)), (BF16, 128, 128, (32, 32)),
    (BF16, 96, 160, (32, 32)), (BF16, 20, 40, (32, 32)),
    (torch.float32, 5, 5, (5, 5)), (torch.float32, 128, 128, (32, 32)),
])
def test_ops_attention_tiles_follow_the_design(monkeypatch, dtype, S, T,
                                               want):
    """ops.attention hands the bf16 kernel tiles of whole 16-row mma
    steps (a short sequence takes one tile, masked past its end) and the
    fp32 kernel the sequence itself when it is shorter than a tile."""
    seen = []

    def spy(q, k, v, **kw):
        seen.append((kw["bq"], kw["bkv"]))
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(ops, "_flash", spy)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, S, 16),
                                             dtype=np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((1, 2, T, 16),
                                             dtype=np.float32)).to(dtype)
    lens = torch.tensor([S], dtype=torch.int32)
    ops.attention(q, k, k, causal=True, q_lens=lens, kv_lens=lens,
                  config=KernelConfig())
    assert seen == [want]


# ----------------------------------------------------------------------
# on the card (skip here)
# ----------------------------------------------------------------------
def _ring(slots):
    return dict(slots=slots, variant="single" if slots == 1 else "dobu")


@pytest.mark.gpu
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("grid_order", ["ijk", "jik"])
def test_sm90_aligned_non_square_on_card(cuda, trans_b, slots, grid_order):
    """M = 4, K = 72, N = 200 in both B layouts: TMA boxes past every
    edge, the swizzle against the wgmma descriptors, one stage (bk 128)
    and two split stages (bk 64)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(4, 72, device=cuda, generator=g).to(BF16)
    b = torch.randn(200, 72, device=cuda, generator=g).to(BF16)
    b = b if trans_b else b.t().contiguous()
    want = matmul_ref(a, b.t() if trans_b else b)
    for bk in (128, 64):
        before = zero_stall_matmul.launches_by_design["sm90"]
        got = zero_stall_matmul(a, b, trans_b=trans_b, bk=bk,
                                grid_order=grid_order, **_ring(slots))
        assert zero_stall_matmul.launches_by_design["sm90"] == before + 1
        err = (got.float() - want.float()).abs().amax(-1)
        assert bool((err <= BF16_TOL * want.float().abs().amax(-1)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 128])
def test_sm90_split_k_is_deterministic_on_card(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(1)
    K, N = GEMMA["ff"], GEMMA["d"]
    a = torch.randn(M, K, device=cuda, generator=g).to(BF16)
    b = torch.randn(K, N, device=cuda, generator=g).to(BF16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert split_plan(M, N, K, 128, 128, 128, sms)[0] > 1
    first = zero_stall_matmul(a, b)
    assert torch.equal(first, zero_stall_matmul(a, b))
    want = matmul_ref(a, b)
    err = (first.float() - want.float()).abs().max()
    assert err <= BF16_TOL * want.float().abs().max()


@pytest.mark.gpu
def test_grouped_launch_stays_on_the_ring_on_card(cuda, monkeypatch):
    """The grouped wrapper follows the design rule: bf16 with TMA-legal
    rows binds the sm90 grouped entry point, fp32 the ring's, and each
    call counts under its design."""
    from repro_torch.kernels import _build
    bound = []
    bind = _build.bind

    def spy(name, *args, **kw):
        bound.append(name)
        return bind(name, *args, **kw)

    monkeypatch.setattr(_build, "bind", spy)
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(4, 8, 64, device=cuda, generator=g)
    b = torch.randn(4, 64, 128, device=cuda, generator=g)
    for dtype, design, entry in ((BF16, "sm90",
                                  "grouped_zero_stall_matmul_sm90"),
                                 (torch.float32, "ring",
                                  "zero_stall_matmul")):
        bound.clear()
        before = dict(grouped_zero_stall_matmul.launches_by_design)
        got = grouped_zero_stall_matmul(a.to(dtype), b.to(dtype), bm=16,
                                        bn=64, bk=64)
        assert bound == [entry]
        assert grouped_zero_stall_matmul.launches_by_design[design] == \
            before[design] + 1
        want = grouped_matmul_ref(a.to(dtype), b.to(dtype))
        tol = BF16_TOL if dtype == BF16 else 2e-5
        assert (got.float() - want.float()).abs().max() <= \
            tol * want.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("shape", [(5, 3, 72, 200), (5, 3, 200, 72),
                                   (3, 130, 136, 264)])
def test_grouped_sm90_ragged_on_card(cuda, slots, shape):
    """Ragged K (72 < bk; 136, 200 past a whole stage), N past a tile
    and M past 128 rows: rank-3 boxes zero-fill inside their group, so
    every row is within 2e-2 of its largest reference magnitude."""
    G, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn(G, M, K, device=cuda, generator=g).to(BF16)
    b = torch.randn(G, K, N, device=cuda, generator=g).to(BF16)
    before = grouped_zero_stall_matmul.launches_by_design["sm90"]
    got = grouped_zero_stall_matmul(a, b, **_ring(slots))
    assert grouped_zero_stall_matmul.launches_by_design["sm90"] == before + 1
    want = grouped_matmul_ref(a, b)
    err = (got.float() - want.float()).abs().amax(-1)
    assert bool((err <= BF16_TOL * want.float().abs().amax(-1)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 80, 128, 256])
def test_flash_tc_lengths_and_masked_row_on_card(cuda, D):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 4, 80, D, device=cuda, generator=g).to(BF16)
               for _ in range(3))
    lens = dict(q_lens=torch.tensor([70, 80], dtype=torch.int32,
                                    device=cuda),
                kv_lens=torch.tensor([70, 0], dtype=torch.int32,
                                     device=cuda))
    before = flash_attention.launches_by_design["tensor_core"]
    got = flash_attention(q, k, v, causal=True, **lens)
    assert flash_attention.launches_by_design["tensor_core"] == before + 1
    want = flash_attention_ref(q, k, v, causal=True, q_offsets=torch.zeros(
        2, dtype=torch.int32, device=cuda), **lens)
    err = (got.float() - want.float()).abs().amax(-1)
    assert bool((err <= BF16_TOL * want.float().abs().amax(-1)).all())
    assert bool((got[1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_flash_one_query_row_on_card(cuda, graph):
    """Encdec cross-attention at decode, (4, 16, 1, 64) against 128
    encoder keys, non-causal, through ops.attention: eagerly, and
    captured in a CUDA graph and replayed on new operands, within 2e-2 of
    each row's largest magnitude of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=g).to(BF16)

    q, k, v = rnd(4, 16, 1, 64), rnd(4, 16, 128, 64), rnd(4, 16, 128, 64)
    before = flash_attention.launches_by_design["tensor_core"]
    if graph:
        ops.attention(q, k, v, causal=False)           # build, warm up
        torch.cuda.synchronize()
        cg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cg):
            got = ops.attention(q, k, v, causal=False)
        for t in (q, k, v):
            t.copy_(rnd(*t.shape))
        cg.replay()
        torch.cuda.synchronize()
    else:
        got = ops.attention(q, k, v, causal=False)
    assert flash_attention.launches_by_design["tensor_core"] == \
        before + 1 + int(graph)
    want = flash_attention_ref(q, k, v, causal=False)
    err = (got.float() - want.float()).abs().amax(-1)
    assert bool((err <= BF16_TOL * want.float().abs().amax(-1)).all())
