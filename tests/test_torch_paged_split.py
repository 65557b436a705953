"""The split-KV design of the paged-attention kernel (``csrc/paged_attention.cu``).

The wrapper cuts a table's T logical pages into contiguous ranges
(:func:`paged_splits`) from B, KV, T and the SM count alone, never from
``kv_lens``; each block keeps its query rows (:func:`paged_rows`) in
registers, streams its pages through a ring (:func:`paged_stages`) and
leaves an (m, l, acc) partial that a second launch folds.  What the
wrapper decides in Python, and the shared-memory formula it shares with
the CUDA source, are held here on the CPU; so is the arithmetic of the
split: partials of contiguous page ranges, folded with weight
exp(m_s - m) and 0 for an empty range, give the plain version's result
and the JAX Pallas kernel's (interpret mode) on the same numpy inputs
within 2e-5 in fp32, with exact zeros for a row with no valid column.
Tests marked ``gpu`` launch the kernel and skip without a card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.plan import KernelConfig as JKernelConfig
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.paged_attention import (paged_attention, paged_rows,
                                                 paged_splits, paged_stages,
                                                 smem_bytes)
from repro_torch.kernels.ref import NEG_INF, paged_attention_ref
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

SMS = 132                            # streaming multiprocessors of an H100
FP32_TOL, BF16_TOL = 2e-5, 2e-2
J_INTERP = JKernelConfig(backend="interpret")
# the paged decode of gemma-7b at 4 slots: 16 kv heads of 256, 16-token
# pages, 10-page tables (max_len 160)
SERVE = dict(B=4, KV=16, T=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# the split plan, rows, ring and shared memory
# ----------------------------------------------------------------------
def test_paged_splits_reads_no_kv_lens():
    """The split count is a function of shapes and the card: kv_lens live
    on the device, and reading them would sync the host in every layer."""
    assert list(inspect.signature(paged_splits).parameters) == [
        "B", "KV", "T", "sms"]


def test_paged_splits_at_the_serving_shape():
    """64 rows of (b, kv head) over a 10-page table: 5 splits of 2 pages,
    320 blocks, about 2.4 a SM."""
    splits, per = paged_splits(sms=SMS, **SERVE)
    assert (splits, per) == (5, 2)
    assert 2 * SMS <= SERVE["B"] * SERVE["KV"] * splits <= 4 * SMS


@pytest.mark.parametrize("T,want", [(1, (1, 1)), (7, (4, 2)), (3, (3, 1)),
                                    (64, (5, 13))])
def test_paged_splits_cut_whole_pages(T, want):
    """At most one split a page, none empty of table pages, the last one
    shorter where the splits do not divide T (T = 7: 2 + 2 + 2 + 1)."""
    splits, per = paged_splits(4, 16, T, SMS)
    assert (splits, per) == want
    assert (splits - 1) * per < T <= splits * per
    if T == 7:
        assert T % splits and T % per


@pytest.mark.parametrize("B,KV", [(32, 16), (66, 4), (1, 1), (2, 2)])
def test_paged_splits_follow_the_rows(B, KV):
    """One split once the rows alone fill the card two blocks deep;
    otherwise about 2 * sms blocks, never more splits than pages."""
    T = 40
    splits, per = paged_splits(B, KV, T, SMS)
    assert (splits - 1) * per < T <= splits * per
    if B * KV >= 2 * SMS:
        assert splits == 1
    assert min(2 * SMS, B * KV * T) <= 2 * B * KV * splits
    assert B * KV * splits <= max(B * KV, 4 * SMS)


@pytest.mark.parametrize("rep,D,elt,rows", [
    (1, 256, 2, 1), (4, 128, 4, 4), (7, 128, 2, 8), (8, 256, 2, 8),
    (8, 256, 4, 8), (8, 512, 2, 4), (12, 128, 2, 8), (3, 16, 4, 4),
    (1, 80, 2, 1), (1, 80, 4, 1)])
def test_paged_rows_keep_a_lane_under_64_floats(rep, D, elt, rows):
    """A block takes up to 8 query rows of a kv head (the next power of
    two of rep), fewer when a lane's share of q would pass 64 floats."""
    assert paged_rows(rep, D, elt) == rows
    lane = -(-(D * elt // 16) // 32) * (16 // elt)
    assert rows * lane <= 64


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("D,ps,rep,elt", [(256, 16, 1, 2), (128, 16, 4, 4),
                                          (256, 16, 8, 2), (8, 4, 4, 4),
                                          (80, 16, 1, 2)])
def test_paged_shared_memory_formula(D, ps, rep, elt, stages):
    """The ring of K and V pages, or the 4 warps' fp32 merge of the
    block's rows if larger (it is written over the ring), then 32 bytes
    of mbarriers: the formula of the CUDA source."""
    ring = stages * 2 * ps * D * elt
    merge = 4 * paged_rows(rep, D, elt) * (D + 2) * 4
    assert smem_bytes(D, ps, rep, elt, stages) == max(ring, merge) + 32
    assert smem_bytes(D, ps, rep, elt) == smem_bytes(D, ps, rep, elt, 2)


@pytest.mark.parametrize("per,D,ps,elt,want", [
    (2, 256, 16, 2, 4), (13, 256, 16, 2, 4), (1, 256, 16, 2, 2),
    (2, 256, 64, 4, 2), (2, 128, 16, 4, 4)])
def test_paged_stages_two_windows(per, D, ps, elt, want):
    """Two windows of two pages where a split has two pages and they fit
    a block, else two windows of one."""
    assert paged_stages(per, D, ps, 1, elt) == want
    assert smem_bytes(D, ps, 1, elt, want) <= pa.SMEM_LIMIT or want == 2


# ----------------------------------------------------------------------
# the split's arithmetic, in plain PyTorch
# ----------------------------------------------------------------------
def _inputs(rng, *, B=4, KV=2, rep=4, D=16, ps=4, T=5):
    """Pools with random contents on every page (the trash page 0 too),
    scattered page ids, row 1 with kv_len 0, row 2 parked on the trash
    page, row 3 with kv_len past its table's T*ps."""
    P = B * T + 1
    q = rng.standard_normal((B, KV * rep, D)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    table = (1 + rng.permutation(P - 1)[:B * T]).reshape(B, T)
    table[2] = 0
    kv_lens = np.array([T * ps - 3, 0, ps + 1, T * ps + 7], np.int32)
    return q, kp, vp, table.astype(np.int32), kv_lens


def _split_then_fold(q, kp, vp, table, kv_lens, splits, per):
    """The kernel's arithmetic in fp32: each split's (m, l, acc) over its
    range of pages (no key: m = -1e30, l = 0), folded in split order."""
    B, H, D = q.shape
    _, ps, KV, _ = kp.shape
    rep, T = H // KV, table.shape[1]
    scale = D ** -0.5
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = int(kv_lens[b])
        n_pages = 0 if n <= 0 else min(T, (n - 1) // ps + 1)
        for h in range(KV):
            qh = q[b, h * rep:(h + 1) * rep]                  # (rep, D)
            m = torch.full((rep,), NEG_INF)
            l, acc = torch.zeros(rep), torch.zeros(rep, D)
            for s in range(splits):
                pages = range(s * per, min((s + 1) * per, n_pages))
                keys = [(table[b, j], c) for j in pages for c in range(ps)
                        if j * ps + c < n]
                if not keys:
                    continue                                  # weight 0
                k = torch.stack([kp[p, c, h] for p, c in keys])
                v = torch.stack([vp[p, c, h] for p, c in keys])
                sc = (qh @ k.T) * scale
                ms = sc.max(-1).values
                p_ = torch.exp(sc - ms[:, None])
                mn = torch.maximum(m, ms)
                wa, ws = torch.exp(m - mn), torch.exp(ms - mn)
                l = l * wa + p_.sum(-1) * ws
                acc = acc * wa[:, None] + (p_ @ v) * ws[:, None]
                m = mn
            out[b, h * rep:(h + 1) * rep] = torch.where(
                l[:, None] > 0, acc / torch.where(l > 0, l, 1.0)[:, None],
                torch.zeros(()))
    return out


@pytest.mark.parametrize("splits_per", [(1, 5), (2, 3), (3, 2), (5, 1)])
def test_split_and_fold_matches_plain_and_jax(rng, splits_per):
    """Every split plan of a 5-page table (3 splits do not divide it)
    gives the plain version's rows and the JAX Pallas kernel's within
    2e-5, and the row with no valid column exact zeros."""
    q, kp, vp, table, kv_lens = _inputs(rng)
    splits, per = splits_per
    got = _split_then_fold(*(torch.from_numpy(x) for x in (q, kp, vp)),
                           table, kv_lens, splits, per)
    want = paged_attention_ref(*(torch.from_numpy(x) for x in
                                 (q, kp, vp, table)),
                               kv_lens=torch.from_numpy(kv_lens))
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    jwant = jops.paged_attention(*(jnp.asarray(x) for x in
                                   (q, kp, vp, table)),
                                 kv_lens=jnp.asarray(kv_lens),
                                 config=J_INTERP)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                               atol=FP32_TOL, rtol=FP32_TOL)
    assert bool((got[1] == 0).all())


def test_zamba2_decode_shape_plan(rng):
    """zamba2-2.7b's paged decode: 4 slots, 32 heads of 80 (rep 1), 16-token
    pages.  A row is 10 16-byte vectors in bf16, not a power of two: the
    kernel's lane group is L = 16 (its last six lanes hold no vector), a
    block one query row, the ring two windows of two 2560-byte pages.
    A 30-page table (480 keys a slot) splits into 3 ranges of 10 pages,
    the serving table of 10 pages (max_len 160) into 3 of 4 (the last
    of 2): 384 blocks either way."""
    assert paged_rows(1, 80, 2) == 1
    nvec = 80 * 2 // 16
    assert nvec == 10 and 1 << (nvec - 1).bit_length() == 16
    assert paged_splits(4, 32, 30, SMS) == (3, 10)
    assert paged_splits(4, 32, 10, SMS) == (3, 4)
    assert paged_stages(10, 80, 16, 1, 2) == 4
    assert smem_bytes(80, 16, 1, 2, 4) == 4 * 2 * 16 * 80 * 2 + 32


@pytest.mark.parametrize("splits_per", [(1, 5), (2, 3), (5, 1)])
def test_split_and_fold_at_head_dim_80_matches_plain_and_jax(rng,
                                                             splits_per):
    """The split arithmetic at zamba2's head dim and one query head a kv
    head, against the plain version and the JAX Pallas kernel in
    interpret mode, within 2e-5 in fp32."""
    q, kp, vp, table, kv_lens = _inputs(rng, KV=3, rep=1, D=80)
    splits, per = splits_per
    got = _split_then_fold(*(torch.from_numpy(x) for x in (q, kp, vp)),
                           table, kv_lens, splits, per)
    want = paged_attention_ref(*(torch.from_numpy(x) for x in
                                 (q, kp, vp, table)),
                               kv_lens=torch.from_numpy(kv_lens))
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    jwant = jops.paged_attention(*(jnp.asarray(x) for x in
                                   (q, kp, vp, table)),
                                 kv_lens=jnp.asarray(kv_lens),
                                 config=J_INTERP)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                               atol=FP32_TOL, rtol=FP32_TOL)
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("rep", [7, 12])
def test_gqa_decode_shapes_plan(rep):
    """llava-next-34b (56 query heads over 8 kv heads: rep 7) and
    mistral-large-123b (96 over 8: rep 12) at head dim 128 in bf16.  A
    block takes 8 query rows: rep 7 fills 7 of them (one past the kv
    head's last query head, masked in the q load and never stored),
    rep 12 takes two blocks a kv head, the second with 4 valid rows of 8.
    The merge of 8 rows outgrows the ring (it is written over it), and
    the combine workspace counts the rep valid rows of each split.  llava
    at 4 slots over a 190-page table (3040 keys) splits into 9 ranges of
    22 pages; mistral over a 30-page table (480 keys) into 8 of 4."""
    assert paged_rows(rep, 128, 2) == 8
    chunks = -(-rep // 8)
    assert chunks == (1 if rep == 7 else 2)
    assert smem_bytes(128, 16, rep, 2, 4) == max(4 * 2 * 16 * 128 * 2,
                                                 4 * 8 * 130 * 4) + 32
    assert paged_stages(4, 128, 16, rep, 2) == 4
    T = 190 if rep == 7 else 30
    s, per = paged_splits(4, 8, T, SMS)
    assert (s - 1) * per < T <= s * per
    assert (s, per) == ((9, 22) if rep == 7 else (8, 4))


def test_seamless_decode_shape_plan():
    """seamless-m4t-large-v2's paged self-attention: 16 heads of 64 (rep
    1), 16-token pages, a 10-page table (max_len 160): one query row a
    block in a lane group of 8, 5 splits of 2 pages."""
    assert paged_rows(1, 64, 2) == 1
    assert paged_splits(4, 16, 10, SMS) == (5, 2)
    assert paged_stages(2, 64, 16, 1, 2) == 4
    assert smem_bytes(64, 16, 1, 2, 4) == 4 * 2 * 16 * 64 * 2 + 32


@pytest.mark.parametrize("rep", [7, 12])
@pytest.mark.parametrize("splits_per", [(1, 5), (2, 3)])
def test_split_and_fold_at_gqa_ratios_matches_plain_and_jax(rng, rep,
                                                            splits_per):
    """The split arithmetic at rep 7 and rep 12 (rows past a kv head's
    query heads are not the kernel's to compute: each kv head's rep rows
    fold on their own), against the plain version and the JAX Pallas
    kernel in interpret mode, within 2e-5 in fp32."""
    q, kp, vp, table, kv_lens = _inputs(rng, KV=2, rep=rep, D=16)
    splits, per = splits_per
    got = _split_then_fold(*(torch.from_numpy(x) for x in (q, kp, vp)),
                           table, kv_lens, splits, per)
    want = paged_attention_ref(*(torch.from_numpy(x) for x in
                                 (q, kp, vp, table)),
                               kv_lens=torch.from_numpy(kv_lens))
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    jwant = jops.paged_attention(*(jnp.asarray(x) for x in
                                   (q, kp, vp, table)),
                                 kv_lens=jnp.asarray(kv_lens),
                                 config=J_INTERP)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                               atol=FP32_TOL, rtol=FP32_TOL)
    assert bool((got[1] == 0).all())


def test_cpu_paged_attention_launches_nothing(rng):
    q, kp, vp, table, kv_lens = (torch.from_numpy(x)
                                 for x in _inputs(rng))
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, table, kv_lens=kv_lens)
    assert paged_attention.launches == before
    torch.testing.assert_close(got, paged_attention_ref(
        q, kp, vp, table, kv_lens=kv_lens))


# ----------------------------------------------------------------------
# on the card (skip here)
# ----------------------------------------------------------------------
def _card_case(dev, seed, *, B, H, KV, D, ps, T, kv_lens, dtype,
               trash_rows=()):
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * T + 1

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    table = (1 + torch.randperm(P - 1, device=dev, generator=g)[:B * T])
    table = table.reshape(B, T).to(torch.int32)
    for b in trash_rows:
        table[b] = 0
    return (rnd(B, H, D), rnd(P, ps, KV, D), rnd(P, ps, KV, D),
            table.contiguous(),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev))


CARD_CASES = [
    dict(B=4, H=16, KV=16, D=256, ps=16, T=10, kv_lens=[160, 129, 80, 17],
         dtype=torch.bfloat16),
    dict(B=4, H=16, KV=16, D=256, ps=16, T=10, kv_lens=[96, 50, 0, 185],
         dtype=torch.bfloat16, trash_rows=(1,)),
    dict(B=4, H=16, KV=4, D=128, ps=16, T=10, kv_lens=[160, 33, 70, 0],
         dtype=torch.float32, trash_rows=(2,)),
    dict(B=4, H=16, KV=16, D=256, ps=16, T=1, kv_lens=[16, 9, 0, 40],
         dtype=torch.bfloat16),
    dict(B=4, H=16, KV=16, D=256, ps=16, T=7, kv_lens=[112, 100, 33, 17],
         dtype=torch.bfloat16),
    dict(B=2, H=8, KV=2, D=8, ps=4, T=8, kv_lens=[13, 5],
         dtype=torch.float32),
    # zamba2-2.7b's decode: 32 heads of 80, rep 1, a 30-page table
    dict(B=4, H=32, KV=32, D=80, ps=16, T=30, kv_lens=[480, 300, 0, 500],
         dtype=torch.bfloat16, trash_rows=(1,)),
    # seamless-m4t-large-v2's decode: 16 heads of 64, rep 1
    dict(B=4, H=16, KV=16, D=64, ps=16, T=10, kv_lens=[160, 97, 0, 170],
         dtype=torch.bfloat16, trash_rows=(1,)),
    # llava-next-34b: 56 heads over 8 kv heads (rep 7), about 3040 keys
    dict(B=4, H=56, KV=8, D=128, ps=16, T=190, kv_lens=[3040, 2901, 0, 17],
         dtype=torch.bfloat16, trash_rows=(2,)),
    # mistral-large-123b: 96 heads over 8 kv heads (rep 12), 480 keys
    dict(B=4, H=96, KV=8, D=128, ps=16, T=30, kv_lens=[480, 300, 0, 500],
         dtype=torch.bfloat16, trash_rows=(1,)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_paged_split_kernel_on_card(cuda, case):
    """Each row within its tolerance of the plain version (bf16 2e-2 of
    the row's largest magnitude, fp32 2e-5), exact zeros for kv_len 0,
    and two calls give the same bits."""
    kw = CARD_CASES[case]
    ops_in = _card_case(cuda, case, **kw)
    before = paged_attention.launches
    got = paged_attention(*ops_in[:4], kv_lens=ops_in[4])
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(*ops_in[:4], kv_lens=ops_in[4])
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    tol = (BF16_TOL * scale if kw["dtype"] == torch.bfloat16
           else FP32_TOL * scale.clamp_min(1.0))
    assert bool((err <= tol).all())
    for b, n in enumerate(kw["kv_lens"]):
        if n == 0:
            assert bool((got[b] == 0).all())
    assert torch.equal(got, paged_attention(*ops_in[:4], kv_lens=ops_in[4]))


@pytest.mark.gpu
def test_paged_kernel_refuses_rows_past_its_registers(cuda):
    q = torch.zeros(1, 2, 512, device=cuda)
    kp = torch.zeros(3, 4, 1, 512, device=cuda)
    table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="registers"):
        paged_attention(q, kp, kp, table, kv_lens=lens)
