"""`repro_torch.analyze` — the static zero-stall verifier on Hopper.

The port of ``repro.analyze``.  The paper's headline claims —
zero-overhead loop nests, zero-conflict memory — are *structural*
properties of schedules and programs, so they can be proven before
anything runs (``repro_torch.obs`` can only observe a stall after the
fact).  Four layers:

1. **Schedule hazards** (:func:`check_config`, :func:`simulate_schedule`)
   — symbolic execution of the N-slot revolving-buffer protocol for one
   kernel config: slot-reuse hazards, the shared-memory budget of a
   Hopper block, the Dobu bank mapping, the ZONL sequencer bound.
2. **Plan lint** (:func:`lint_plan`) — whole-`repro_torch.plan.Plan`
   validation: tile legality, int8 accumulator safety, out_dtype
   safety, decode-path buffer depth, replica fault-policy pairing.
   ``ServeEngine(plan=..., validate=True)`` runs it at load time.
3. **Program lint** (:func:`lint_program`) — the ATen operators of the
   prefill / decode / loss programs under a dispatch mode: fallback
   matmuls, host sync points inside the fused dispatch, int8 upcasts on
   the quantized path, stale allowlist entries across full-family
   sweeps.
4. **Kernel launch verification** (:func:`lint_kernels`) — each
   kernel's launch geometry (what its wrapper hands the CUDA entry) is
   replayed and proven to realize the schedule layers 1–2 reason about:
   residency timeline, producer look-ahead, bank pattern, walk order and
   coverage, storage aliasing.

``python -m repro_torch.analyze`` runs them over the model-family
configs (``--kernels`` selects layer 4's tuning-space sweep).  Rule ids
(``RULES``) are the JAX package's and stable API; their severities are
too, except ``ZS-S004``'s: an error only, since on Hopper the staging
budget is a block's whole shared memory (no warning tier below it).
"""

from __future__ import annotations

from repro_torch.analyze.diagnostics import SEVERITIES, Diagnostic, Report
from repro_torch.analyze.driver import (FAMILY_ARCHS, analyze_arch,
                                        analyze_families)
from repro_torch.analyze.hazards import (bank_access_pattern, check_config,
                                         check_paged, simulate_schedule)
from repro_torch.analyze.kernel_lint import (KERNEL_FAMILIES, KernelIR,
                                             lint_kernel_ir, lint_kernels,
                                             trace_kernel_irs)
from repro_torch.analyze.plan_lint import (lint_cluster, lint_page_geometry,
                                           lint_plan)
from repro_torch.analyze.program_lint import (DEFAULT_ALLOW, check_allowlist,
                                              lint_program, merge_allow_hits)

__all__ = [
    "Diagnostic", "Report", "SEVERITIES", "RULES",
    "check_config", "check_paged", "simulate_schedule",
    "bank_access_pattern", "lint_plan", "lint_page_geometry",
    "lint_cluster", "lint_program", "check_allowlist", "merge_allow_hits",
    "DEFAULT_ALLOW", "KERNEL_FAMILIES", "KernelIR", "trace_kernel_irs",
    "lint_kernel_ir", "lint_kernels",
    "FAMILY_ARCHS", "analyze_arch", "analyze_families",
]

RULES = {
    "ZS-S001": ("error", "schedule",
                "zero-conflict buffering: DMA-in never overwrites a slot "
                "whose operands a step still needs"),
    "ZS-S002": ("info", "schedule",
                "serialized single-buffer baseline (stalls by design — "
                "the Base32fc analogue)"),
    "ZS-S003": ("error", "schedule",
                "prologue completeness: every compute step's operands "
                "are primed before it issues"),
    "ZS-S004": ("error", "schedule",
                "revolving buffers fit a Hopper block's shared memory, "
                "all of which the kernels stage (double buffering trades "
                "memory for stalls)"),
    "ZS-S005": ("error", "schedule",
                "model coherence: symbolic execution, the closed-form "
                "schedule and the Dobu bank mapping agree"),
    "ZS-S007": ("error", "schedule",
                "ZONL: the sequencer issues the tile nest in exactly "
                "total_issued cycles (zero control overhead)"),
    "ZS-S008": ("error", "schedule",
                "paged KV: the per-slot page table covers max_len "
                "(capacity = table_len * page_size tokens)"),
    "ZS-L001": ("error", "plan", "every plan OpKey is resolvable"),
    "ZS-L002": ("error", "plan",
                "entry backend does not contradict the plan backend"),
    "ZS-L003": ("warning", "plan",
                "tiles never exceed the padded bucket dims (no pure "
                "zero-padding work)"),
    "ZS-L004": ("error", "plan",
                "int8 entries accumulate in int32, never int8"),
    "ZS-L005": ("warning", "plan", "out_dtype is a safe output type"),
    "ZS-L006": ("warning", "plan",
                "decode-hot GEMMs run the revolving buffer (slots >= 2)"),
    "ZS-L007": ("warning", "plan",
                "entry quant mode agrees with the plan quant mode"),
    "ZS-L008": ("error", "plan",
                "paged KV: page_size tiles every attention entry's KV "
                "block (bkv % page_size == 0)"),
    "ZS-L009": ("error", "plan",
                "every serving replica executes one plan (all "
                "Plan.fingerprint()s equal — divergent configs make "
                "tokens placement-dependent)"),
    "ZS-F001": ("warning", "plan+policy",
                "transient failures get at least one in-place retry"),
    "ZS-F002": ("error", "plan+policy", "retry backoff is well-formed"),
    "ZS-F003": ("warning", "plan+policy",
                "replica restarts resolve configs by lookup, not by "
                "re-tuning"),
    "ZS-F004": ("error", "plan+policy",
                "router fault policy bounds total re-queue backoff "
                "below the request timeout"),
    "ZS-P001": ("error", "program",
                "every matmul routes through the zero-stall kernels "
                "(no silent jnp fallback)"),
    "ZS-P002": ("error", "program",
                "no host sync points inside the fused K-step dispatch"),
    "ZS-P003": ("warning", "program",
                "the quantized path never dequantizes into a "
                "full-precision matmul"),
    "ZS-P004": ("warning", "program",
                "the fallback allowlist stays live: every sanctioned "
                "site still exists across the full-family sweep"),
    "ZS-K001": ("error", "kernel-ir",
                "kernel/config schedule coherence: the IR-derived "
                "residency timeline matches RevolvingSchedule, the "
                "hazard simulation and the declared contract"),
    "ZS-K002": ("error", "kernel-ir",
                "no overlapping shared-memory stages across in-flight "
                "ring steps (a copy never lands in a slot a step still "
                "reads)"),
    "ZS-K003": ("error", "kernel-ir",
                "the derived compute/DMA access pattern stays "
                "bank-disjoint under the Dobu mapping"),
    "ZS-K004": ("error", "kernel-ir",
                "HBM streaming: the grid walk never revisits an "
                "output block after eviction (accumulation runs are "
                "contiguous)"),
    "ZS-K005": ("error", "kernel-ir",
                "input_output_aliases never overwrite an input window "
                "a later grid step still reads"),
}
