"""Hopper pipeline model: the predicted time of one kernel launch on an H100.

The port's counterpart of ``repro.core.cyclemodel.TpuPipelineModel``.
The TPU model prices one core walking a serial grid; an H100 runs a
launch as blocks spread over 132 SMs.  So this model prices the launch
each wrapper actually makes, from the wrappers' own rules
(:func:`~repro_torch.kernels.zero_stall_matmul.select_design`,
:func:`~repro_torch.kernels.zero_stall_matmul.sm90_rows`,
:func:`~repro_torch.kernels.zero_stall_matmul.split_plan`,
:func:`~repro_torch.kernels.grouped_matmul.grouped_blocks`): the output
tiles, the k splits and the ring stages a block streams.  It charges

* a fixed cost a launch, and a second launch (reading and writing the
  fp32 or int32 partials) where split-k cuts K over blocks;
* the blocks in waves over the SMs, as many resident on an SM as its
  shared memory holds, which then share that SM's load path;
* each block's ring: with ``slots >= 2`` a fill of one round trip, then
  per stage max(compute, copy) at the rate the bytes in flight
  (``slots`` stages) sustain over the round trip, at most one SM's share
  of HBM; with ``slots = 1`` copy and compute in series, a round trip
  each stage (the serialized baseline);
* the whole launch's HBM bytes (weights, activations once, output,
  split partials, and the weight bytes the L2 cannot keep between row
  tiles read again) over the HBM rate: a wave takes at least its share;
* a fixed cost a ring turn and a fixed cost an output tile (epilogue).

Shared memory replaces the TPU model's VMEM budget: a block's footprint
is the wrappers' own formula, which sets how many blocks an SM holds here
and which tiles are legal in :mod:`repro_torch.tune.space`.
Device constants come from ``torch.cuda.get_device_properties`` where it
has them (SMs, L2, shared memory a block); the peaks and the HBM rate
are NVIDIA's H100 SXM data-sheet figures (dense, at the 700 W limit).
The fixed costs (launch, round trip, SM load rate, ring turn, tile,
flash's step and copy issue) and the shares of the tensor-core peak the
kernels reach are fitted by a grid search to the port's own chip
tables: ``PERF.md`` §6 (kernels 1, 2, 4, 5 and 6 at the main paths'
shapes) and every candidate of the tuner's space measured at gemma-7b's
and olmoe-1b-7b's shapes by ``chip_smoke.py`` phase 5m
(``tests/data/h100_matmul_tables.csv``, and flash's tiles at (1, 16,
128, 256)), all on an NVIDIA H100 80GB HBM3 at 700 W;
``tests/test_torch_tune.py`` holds the model to them.

Beside it, copied from the JAX package unchanged, the paper's own
instrument: ``SnitchClusterModel``, the cycle model of the Snitch cluster
in its five configurations (``SNITCH_CONFIGS``, paper Table I), which the
static analyzer (:mod:`repro_torch.analyze.hazards`) reads for the
silicon's conflict-freedom.  It is plain Python and numpy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.loopnest import Loop, LoopNest

__all__ = ["HopperParams", "HopperPipelineModel", "KernelEstimate",
           "SnitchConfig", "SNITCH_CONFIGS", "SnitchClusterModel",
           "MatmulResult"]

# the matmul kernels' types by element width: 1 byte int8, 2 bf16, 4 fp32
_DTYPES = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}


@dataclasses.dataclass(frozen=True)
class HopperParams:
    """One H100 SXM's constants (data sheet) and the model's fixed costs.

    ``peak_flops`` are the dense tensor-core rates (bf16 and int8) and
    the fp32 rate outside the tensor cores; ``wgmma_fraction`` is the
    share of its type's peak the TMA ring's ``wgmma`` products are priced
    at, ``mma_sync_fraction`` the share of the bf16 peak of the cp.async
    ring's ``mma.sync`` path, ``attn_fraction`` that of flash attention's
    inner products.  The fixed costs below them are fitted to the port's chip
    tables (module docstring); ``tests/test_torch_tune.py`` states the
    factor each table is held to.
    """

    sms: int = 132
    l2_bytes: int = 50 * 1024 * 1024
    smem_per_block: int = 232448
    smem_per_sm: int = 233472
    hbm_bw: float = 3.35e12
    peak_flops: tuple = (("bfloat16", 989e12), ("int8", 1979e12),
                         ("float32", 67e12))
    wgmma_fraction: float = 0.55
    mma_sync_fraction: float = 0.5
    attn_fraction: float = 0.3
    launch_s: float = 3.0e-6          # a launch inside a CUDA graph
    latency_s: float = 0.9e-6         # one TMA stage's round trip, loaded
    sm_bw: float = 90e9               # the most one SM's blocks draw
    stage_s: float = 0.03e-6          # a ring turn (mbarriers, issue)
    tile_s: float = 2.4e-6            # an output tile's epilogue
    attn_step_s: float = 0.9e-6       # a flash kv step's softmax work
    attn_warp_bw: float = 10e9        # K/V bytes a warp's copies issue

    def peak(self, dtype: str) -> float:
        return dict(self.peak_flops)[dtype]

    @classmethod
    def from_device(cls, index: int = 0, **overrides) -> "HopperParams":
        """The constants of CUDA device ``index`` where its properties
        give them (SMs, L2 bytes, shared memory a block), the data sheet
        elsewhere."""
        props = torch.cuda.get_device_properties(index)
        kw = {"sms": props.multi_processor_count}
        l2 = getattr(props, "L2_cache_size", None)
        if l2:
            kw["l2_bytes"] = int(l2)
        smem = getattr(props, "shared_memory_per_block_optin", None)
        if smem:
            kw["smem_per_block"] = int(smem)
        smem_sm = getattr(props, "shared_memory_per_multiprocessor", None)
        if smem_sm:
            kw["smem_per_sm"] = int(smem_sm)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class KernelEstimate:
    """The model's price of one launch (seconds) and its bound.

    ``bound_s`` is the least time the card could take for the same work:
    the larger of the unique bytes over the HBM rate and the operations
    over the peak rate of their type (the measure ``chip_smoke.py``
    prints as ``bound_ms``); ``utilization`` is ``bound_s / total_s``.
    """

    name: str
    total_s: float
    bound_s: float
    flops: float
    bytes_moved: float
    design: str
    blocks: int
    splits: int
    stages: int

    @property
    def utilization(self) -> float:
        return self.bound_s / self.total_s


def _dtype_name(dtype_bytes: int) -> str:
    return {1: "int8", 2: "bfloat16", 4: "float32"}[dtype_bytes]


class HopperPipelineModel:
    """The predicted time of the port's kernels on one H100 (see the
    module docstring).  Default oracle of :mod:`repro_torch.tune`."""

    def __init__(self, params: HopperParams | None = None):
        self._p = params

    @property
    def p(self) -> HopperParams:
        """The constants priced with: those given, else the current CUDA
        device's (:meth:`HopperParams.from_device`, read at first use),
        else the data sheet's (no card: a plan traced on the CPU)."""
        if self._p is None:
            self._p = (HopperParams.from_device(torch.cuda.current_device())
                       if torch.cuda.is_available() else HopperParams())
        return self._p

    # ------------------------------------------------------------------
    def design(self, dtype_bytes: int, K: int, N: int,
               trans_b: bool = False) -> str:
        """The design the wrappers run a product of this type and shape
        on, for operands at aligned bases (:func:`select_design`)."""
        from repro_torch.kernels.zero_stall_matmul import select_design
        return select_design(_DTYPES[dtype_bytes], K, N, trans_b)

    def _resident(self, smem: int) -> int:
        """Blocks one SM holds at ``smem`` bytes of shared memory each."""
        return max(1, min(4, self.p.smem_per_sm // (smem + 1024)))

    def _stage_s(self, stage_bytes: float, comp_s: float, slots: int,
                 share: int) -> float:
        """One ring stage of a block whose SM holds ``share`` streaming
        blocks, which share its load path and its tensor cores: copy and
        compute overlapped behind ``slots`` stages in flight, or in series
        at ``slots = 1``."""
        p = self.p
        sm_rate = p.sm_bw / share
        comp_s *= share
        if slots == 1:
            return p.latency_s + stage_bytes / sm_rate + comp_s + p.stage_s
        rate = min(sm_rate, slots * stage_bytes / p.latency_s)
        return max(stage_bytes / rate, comp_s + p.stage_s)

    def _waves(self, blocks: int, resident: int, block_s, hbm_bytes: float
               ) -> float:
        """Time of ``blocks`` blocks in waves of ``sms * resident``;
        ``block_s(share)`` is one block's time when ``share`` blocks
        stream on its SM, and a wave takes at least its share of the
        launch's HBM bytes."""
        p = self.p
        per_wave = p.sms * resident
        total, left = 0.0, blocks
        while left > 0:
            active = min(left, per_wave)
            share = -(-active // p.sms)
            wave_hbm = hbm_bytes * active / blocks / p.hbm_bw
            total += max(block_s(share), wave_hbm + p.latency_s)
            left -= active
        return total

    # ------------------------------------------------------------------
    def matmul(self, M: int, N: int, K: int, bm: int, bn: int, bk: int, *,
               dtype_bytes: int = 2, slots: int = 2, groups: int = 1,
               out_bytes: int | None = None, trans_b: bool = False,
               name: str = "matmul") -> KernelEstimate:
        """Price one matmul launch: (G,) M x K @ K x N with the given
        tiles and ring depth, as the wrapper of its design launches it."""
        from repro_torch.kernels import zero_stall_matmul as zs
        from repro_torch.kernels.grouped_matmul import grouped_blocks
        p = self.p
        G = max(1, groups)
        eb = dtype_bytes
        ob = out_bytes if out_bytes is not None else (4 if eb == 1 else eb)
        dname = _dtype_name(eb)
        design = self.design(eb, K, N, trans_b)
        flops = 2.0 * G * M * N * K
        hbm = G * ((M + N) * K * eb + M * N * ob)
        splits = 1
        if design == "sm90":
            rows = zs.sm90_rows(M, bm)
            tiles = -(-M // rows) * -(-N // bn)
            stage_bytes = (bn + rows) * bk * eb
            peak = p.peak(dname) * p.wgmma_fraction
            comp = 2.0 * bn * bk * max(rows, 16) / (peak / p.sms)
            if G == 1:
                splits, per = zs.split_plan(M, N, K, bm, bn, bk, p.sms)
                blocks, tiles_a_block, stages = tiles * splits, 1, per
            else:
                blocks = grouped_blocks(G, M, N, rows, bn, p.sms)
                tiles_a_block = -(-G * tiles // blocks)
                stages = tiles_a_block * -(-K // bk)
            smem = zs.sm90_smem_bytes(rows, bn, bk, slots, eb)
        else:
            tiles = -(-M // bm) * -(-N // bn)
            blocks, tiles_a_block = G * tiles, 1
            stages = -(-K // bk)
            stage_bytes = (bm + bn) * bk * eb
            peak = (p.peak("float32") if eb == 4
                    else p.peak(dname) * p.mma_sync_fraction)
            comp = 2.0 * bm * bn * bk / (peak / p.sms)
            smem = zs.smem_bytes(bm, bn, bk, slots, _DTYPES[eb], trans_b)
        part = 4 * M * N * splits if splits > 1 else 0
        # each row tile streams all of B: what of B the L2 cannot hold
        # comes from HBM again for every row tile after the first
        b_bytes = G * N * K * eb
        row_tiles = -(-M // (rows if design == "sm90" else bm))
        reread = (row_tiles - 1) * max(0.0, b_bytes - p.l2_bytes)
        fill = p.latency_s if slots >= 2 else 0.0

        def block_s(share: int) -> float:
            return (fill + stages * self._stage_s(stage_bytes, comp, slots,
                                                  share)
                    + tiles_a_block * p.tile_s)

        total = p.launch_s + self._waves(blocks, self._resident(smem),
                                         block_s, hbm + part + reread)
        if splits > 1:          # the reduction's launch over the partials
            total += p.launch_s + (part + M * N * ob) / p.hbm_bw
        bound = max(hbm / p.hbm_bw, flops / p.peak(dname))
        return KernelEstimate(name=name, total_s=total, bound_s=bound,
                              flops=flops, bytes_moved=float(hbm),
                              design=design, blocks=blocks, splits=splits,
                              stages=stages)

    def attention(self, bq: int, bkv: int, *, s_q: int, s_kv: int,
                  head_dim: int, dtype_bytes: int = 2, batch_heads: int = 1,
                  causal: bool = True, name: str = "attention"
                  ) -> KernelEstimate:
        """Price one flash-attention launch: one block a (sequence, head,
        q tile), each streaming its kv tiles (up to the causal frontier,
        start-aligned) through a two-stage ring; bf16 on the tensor cores
        (``mma.sync``), fp32 on the CUDA cores.  The launch takes the
        longer of its critical path (the longest block's kv steps, alone
        on an SM) and its throughput (every block's steps over the SMs,
        as many blocks on an SM as its shared memory holds)."""
        from repro_torch.kernels.flash_attention import smem_bytes
        p = self.p
        D, eb = head_dim, dtype_bytes
        dtype = _DTYPES[eb]
        nq = -(-s_q // bq)
        blocks = batch_heads * nq
        peak = (p.peak("float32") if eb == 4
                else p.peak("bfloat16")) * p.attn_fraction
        # a warp owns 16 query rows: up to four run side by side on an
        # SM's tensor cores, and the block's warps share the K/V tile's
        # copies, so a step costs the products of max(1, bq / 64) warps
        # and the copies split over bq / 16 warps
        warps = max(1, bq // 16)
        comp = 4.0 * 16 * bkv * D * max(1, warps / 4) / (peak / p.sms)
        tile_bytes = 2 * bkv * D * eb
        issue = tile_bytes / (warps * p.attn_warp_bw)

        def steps(i: int) -> int:
            hi = min(s_kv, (i + 1) * bq) if causal else s_kv
            return max(1, -(-hi // bkv))

        longest = max(steps(i) for i in range(nq))
        n_steps = batch_heads * sum(steps(i) for i in range(nq))
        flops = 4.0 * batch_heads * s_q * s_kv * D * (0.5 if causal else 1)
        hbm = batch_heads * (2 * s_q + 2 * s_kv) * D * eb
        share = min(self._resident(smem_bytes(D, bq, bkv, dtype)),
                    -(-blocks // p.sms))

        def step_s(n: int) -> float:
            # the fixed part of a step waits (barriers, softmax
            # reductions): co-resident blocks overlap it
            return self._stage_s(tile_bytes, comp, 2, n) + p.attn_step_s \
                + issue

        total = p.launch_s + p.latency_s + p.tile_s + max(
            longest * step_s(1), n_steps * step_s(share) / (share * p.sms),
            hbm / p.hbm_bw)
        bound = max(hbm / p.hbm_bw,
                    flops / p.peak("float32" if eb == 4 else "bfloat16"))
        return KernelEstimate(name=name, total_s=total, bound_s=bound,
                              flops=flops, bytes_moved=float(hbm),
                              design="tensor_core" if eb == 2 else
                              "cuda_core", blocks=blocks, splits=1,
                              stages=n_steps)


# ----------------------------------------------------------------------
# Snitch cluster configurations (paper Table I)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SnitchConfig:
    name: str
    zonl: bool            # zero-overhead loop nests
    banks: int            # TCDM banks
    hyperbanks: int       # 1 = single address space (fc), 2 = dobu
    dobu: bool            # double-buffering-aware interconnect
    tcdm_kib: int
    # --- energy model (relative units, calibrated to Table II) ---
    # per-TCDM-access interconnect+bank energy [pJ]; larger crossbars
    # cost more per access (paper Sec. V-B / Gautschi et al.).
    e_access_pj: float
    # control (cores, I$, sequencer) power at full issue rate [mW].
    p_ctrl_mw: float

    @property
    def conflict_free(self) -> bool:
        """Zero-conflict memory subsystem?

        64 banks satisfy the worst-case RISC-V port demand
        ((3 reads + 1 write) * 8 cores * 2 = 64); 48 banks with the
        Dobu interconnect are conflict-free for double-buffered matmul
        (24-bank hyperbank >= 24 simultaneous core requests, DMA in the
        other hyperbank).
        """
        return self.banks >= 64 or (self.dobu and self.banks >= 48)


# Calibration notes:
#   * e_access_pj reproduces Table II "L1 Mem.+Interco." power ratios:
#     Base32fc 47.5+36.9 mW vs Zonl48dobu 36.9+36.9 mW, and the +12%
#     median energy of Zonl64fc (Fig. 5) from its big 64-port crossbar.
#   * p_ctrl_mw reproduces Ctrl 186.3 (base) / 189.2 (zonl) mW: the
#     sequencer adds ~3 mW but saves I$ fetches in steady state.
SNITCH_CONFIGS = {
    "base32fc": SnitchConfig("base32fc", False, 32, 1, False, 128, 1.00, 186.3),
    "zonl32fc": SnitchConfig("zonl32fc", True, 32, 1, False, 128, 1.00, 189.2),
    "zonl64fc": SnitchConfig("zonl64fc", True, 64, 1, False, 128, 1.90, 189.2),
    "zonl64dobu": SnitchConfig("zonl64dobu", True, 64, 2, True, 128, 1.12, 189.2),
    "zonl48dobu": SnitchConfig("zonl48dobu", True, 48, 2, True, 96, 0.95, 189.2),
}


@dataclasses.dataclass(frozen=True)
class MatmulResult:
    config: str
    M: int
    N: int
    K: int
    cycles: int
    useful_cycles: int          # FPU MAC-issue cycles (paper's utilization basis)
    stall_cycles_conflict: int
    overhead_cycles_loop: int
    dma_cycles: int
    power_mw: float

    @property
    def utilization(self) -> float:
        return self.useful_cycles / self.cycles

    @property
    def perf_gflops(self) -> float:
        # Paper accounting: peak = 8 DPGflop/s for 8 FPUs @ 1 GHz.
        return 8.0 * self.utilization

    @property
    def energy_eff_gflops_w(self) -> float:
        return self.perf_gflops / (self.power_mw * 1e-3)


class SnitchClusterModel:
    """Cycle model of the 8+1-core Snitch cluster running FP64 matmul."""

    N_CORES = 8
    UNROLL = 8                # paper footnote 2: actual implementations use 8
    FPU_LATENCY = 4           # RAW distance hidden by unrolling
    DMA_BYTES_PER_CYCLE = 64  # 512-bit port
    WORD = 8                  # FP64
    # Calibrated once against Table II (32x32x32 anchors: base 95.3%,
    # zonl48dobu 99.0%):
    KERNEL_STARTUP = 41       # SSR/FREP config + pipeline fill per tile kernel
    OUTER_OVERHEAD = 10       # per outer-loop iteration, non-ZONL (2 mgmt
                              # instrs + taken-branch refetch + addr bookkeeping)
    # L1 block tiling used for double-buffered execution (paper: layout
    # constrains each matrix to 8 banks / 32 KiB -> 32x32 FP64 blocks; a
    # 32x32x32 block is the common case, footnote to Sec. III-A).
    BLOCK = 32
    # Compute-core power at full utilization [mW] (Table II: 106.7 mW at
    # 95.3% util -> 112 mW at 100%).
    P_COMP_FULL = 112.0
    # Interconnect static+clock power [mW] (Table II column shared 36.9).
    P_INTERCO = 36.9

    def __init__(self, config: SnitchConfig):
        self.cfg = config

    # ------------------------------------------------------------------
    # Core issue timing for one (m_rows x N x K) slice on one core
    # ------------------------------------------------------------------
    def _core_cycles(self, m_rows: int, n: int, k: int) -> tuple[int, int, int]:
        """(issue_cycles, useful_cycles, loop_overhead) for one core.

        Kernel structure (paper Fig. 1b): collapsed outer loop over
        m_rows * ceil(n/unroll) groups; each group runs k steps of
        `u_eff` MAC instructions (first iteration fmul, last writes
        back through the store SSR — both useful FPU work).  When
        u_eff < FPU latency the accumulator RAW dependence stalls the
        pipe to FPU_LATENCY cycles per step.
        """
        if m_rows == 0 or n == 0 or k == 0:
            return 0, 0, 0
        useful = 0
        issue = 0
        n_outer = 0
        full_groups, rem = divmod(n, self.UNROLL)
        for u_eff, groups in ((self.UNROLL, full_groups), (rem, 1 if rem else 0)):
            if groups == 0:
                continue
            per_group_useful = k * u_eff
            per_group_issue = k * max(u_eff, self.FPU_LATENCY)
            useful += m_rows * groups * per_group_useful
            issue += m_rows * groups * per_group_issue
            n_outer += m_rows * groups
        overhead = 0 if self.cfg.zonl else n_outer * self.OUTER_OVERHEAD
        return issue + overhead + self.KERNEL_STARTUP, useful, overhead

    # ------------------------------------------------------------------
    # Bank-conflict model (32-bank configurations only)
    # ------------------------------------------------------------------
    def _conflict_probability(self, rng: np.random.Generator | None = None) -> float:
        """P(core stalls | DMA active this cycle), from bank geometry.

        Layout (from [6], adopted by the paper): A, B, C each constrained
        to one 8-bank superbank -> core reads spread over the 16 banks
        of A/B superbanks (+8 for C writeback).  The DMA moves next A/B
        and previous C through its 512-bit port, sweeping one superbank
        per cycle.  A core stalls if either of its two SSR reads hits
        the superbank the DMA occupies (the per-superbank mux grants the
        DMA, paper Sec. II).  Conflict-free configs return 0.
        """
        if self.cfg.conflict_free:
            return 0.0
        # With 32 banks = 4 superbanks and 6 live buffers (A,B,C x 2 for
        # double buffering, each pinned to an 8-bank superbank by the
        # conflict-minimizing layout of [6]), buffer placement cannot be
        # disjoint: current A(8)+B(8)+C(8) occupy 3 superbanks, leaving
        # one free.  Next-A lands in the free superbank; prev-C overlaps
        # the C superbank the cores touch only once per K cycles
        # (negligible); next-B must share a live read superbank.  The
        # DMA services its three streams round-robin, so during an
        # active DMA cycle the 512-bit beat (covering a whole superbank)
        # collides with the cores' B-stream reads 1/3 of the time, and
        # the per-superbank mux grants the DMA (paper Sec. II).
        return 1.0 / 3.0

    # ------------------------------------------------------------------
    # Whole-problem execution (double-buffered over 32^3 L1 blocks)
    # ------------------------------------------------------------------
    def matmul(self, M: int, N: int, K: int, *,
               include_dma: bool = True) -> MatmulResult:
        B = self.BLOCK
        mb, nb, kb = (math.ceil(M / B), math.ceil(N / B), math.ceil(K / B))

        total_issue = 0
        total_useful = 0
        total_loop_oh = 0
        total_dma = 0
        total_conflict = 0
        p_conf = self._conflict_probability() if include_dma else 0.0

        # Iterate L1 blocks; each block: rows split round-robin over 8
        # cores; cluster time = max over cores (barrier); DMA moves the
        # next A/B blocks and previous C block concurrently.
        for bm in range(mb):
            m_blk = min(B, M - bm * B)
            for bn in range(nb):
                n_blk = min(B, N - bn * B)
                for bk in range(kb):
                    k_blk = min(B, K - bk * B)
                    rows = [m_blk // self.N_CORES
                            + (1 if c < m_blk % self.N_CORES else 0)
                            for c in range(self.N_CORES)]
                    per_core = [self._core_cycles(r, n_blk, k_blk) for r in rows]
                    blk_issue = max(c for c, _, _ in per_core)
                    blk_useful = sum(u for _, u, _ in per_core)
                    blk_loop_oh = max((o for _, _, o in per_core), default=0)

                    dma_bytes = (m_blk * k_blk + k_blk * n_blk) * self.WORD
                    if bk == kb - 1:  # C writeback + next C prefetch
                        dma_bytes += 2 * m_blk * n_blk * self.WORD
                    dma_cyc = math.ceil(dma_bytes / self.DMA_BYTES_PER_CYCLE)

                    if include_dma:
                        if self.cfg.conflict_free:
                            # Dobu/64-bank: DMA fully overlapped, zero stalls.
                            blk_time = max(blk_issue, dma_cyc)
                            conflict = 0
                        else:
                            # Shared banks: while the DMA is active the losing
                            # core requests stall (superbank mux).
                            overlap = min(blk_issue, dma_cyc)
                            conflict = math.ceil(
                                overlap * p_conf / max(1e-9, 1 - p_conf))
                            blk_time = max(blk_issue + conflict, dma_cyc)
                    else:
                        blk_time = blk_issue
                        conflict = 0
                        dma_cyc = 0

                    total_issue += blk_time
                    total_useful += blk_useful
                    total_loop_oh += blk_loop_oh
                    total_dma += dma_cyc
                    total_conflict += conflict

        # utilization basis: useful MAC issue slots per core-cycle
        cycles = total_issue
        useful = math.ceil(total_useful / self.N_CORES)
        power = self._power(useful / cycles, p_conf if include_dma else 0.0)
        return MatmulResult(
            config=self.cfg.name, M=M, N=N, K=K,
            cycles=cycles, useful_cycles=useful,
            stall_cycles_conflict=total_conflict,
            overhead_cycles_loop=total_loop_oh,
            dma_cycles=total_dma,
            power_mw=power,
        )

    # ------------------------------------------------------------------
    def _power(self, util: float, p_conf: float) -> float:
        """Component power model calibrated to Table II (mW)."""
        p_comp = self.P_COMP_FULL * util
        # Memory accesses: 2 reads/MAC-cycle/core (+~1/K writes, folded in),
        # at ~2.1 GHz-normalized access rate; conflicts re-issue requests
        # (wasted energy, paper Sec. IV-B).
        access_rate = 2.0 * self.N_CORES * util * (1.0 + 0.5 * p_conf)
        p_mem = 2.31 * access_rate * self.cfg.e_access_pj  # mW @ 1 GHz
        return p_comp + p_mem + self.P_INTERCO + self.cfg.p_ctrl_mw

    # ------------------------------------------------------------------
    def loopnest_for_block(self, m_rows: int, n: int, k: int) -> LoopNest:
        """The per-core matmul nest as a LoopNest (for cross-validation)."""
        groups = max(1, n // self.UNROLL)
        return LoopNest(
            num_insts=self.UNROLL,
            loops=(
                Loop(trips=max(1, m_rows * groups), start=0,
                     end=self.UNROLL - 1, name="mn"),
                Loop(trips=max(1, k), start=0, end=self.UNROLL - 1, name="k"),
            ),
        )
