"""Continuous-batching serving engine with block decode dispatch.

The port of ``repro.serve.engine`` in contiguous-cache mode.  A request
queue feeds a fixed pool of decode slots.  Each engine step (1) admits
queued requests into free slots, one batch-1 ``Model.prefill`` per
request padded to a length bucket, and installs its KV stripe into the
stacked ``(n_layers, num_slots, max_len, KV, D)`` cache, and (2) runs
one block of ``steps_per_dispatch`` (K) decode+sample iterations over
all slots, with per-slot done and budget masks kept on the device.  The
host reads the ``(num_slots, K)`` token tile once per block through
:func:`_host`, the one device->host boundary, so a block costs one sync
(plus one per admission for its first token).  Finished rows are frozen
inside a block: they re-feed their last token and the host discards
what they emit after their done point, so the tokens are the same for
every K.

The K-step block is one function of static buffers (the cache, the
slots' sampling keys and one packed tensor of per-dispatch operands), so
on a CUDA device it runs as one captured CUDA graph a variant (greedy
only, sampled): the first dispatch of a variant runs it eagerly, which
builds and binds the kernels, and the graph is captured after it; every
later dispatch copies its operands in with one host->device copy and
replays the graph.  Prefill runs the same way, as the JAX engine jits
it once a shape: one graph a prompt bucket and frontend shape, over a
static ``(1, bucket)`` token buffer (rewritten whole at every
admission, zeros past the prompt, as JAX pads), a ``(1,)`` lengths
buffer and the frontend's buffer; and one graph a chunk shape, over
static token, offset and lengths buffers (the chunk's offset is a
device tensor, as JAX traces it).  Every one of these graphs writes its
cache into one batch-1 buffer of the engine's, made outside the graphs'
pool, so no graph holds a ``max_len`` cache of its own: the prefill's
is installed at once, and the chunk stripe is handed from one chunked
admission to another (the rows of the one it leaves saved, the other's
restored).  The graphs share one memory pool: a replay's outputs are
consumed (installed, or copied) before any other of them replays.  The
first-token sampler and the paged insert stay eager: a few ops an
admission, which JAX jits as programs of their own.  A capture or a
replay that fails raises; there is no eager fallback on the card.  On
the CPU the same functions run eagerly on the same static buffers.
Greedy decode through the engine is token-for-token identical to
:func:`lockstep_generate`.  Sampling keys are the JAX package's
threefry key data (:mod:`repro_torch.serve.sampling`), so a seeded
request samples the tokens it samples in the JAX engine.  Admissions,
prefill chunks, dispatches and retirements emit the JAX engine's spans
and events (:mod:`repro_torch.obs`).

The cache is family-agnostic: each leaf's batch axis is probed once
from ``init_cache`` at batch 1 and 2 (shapes only, on the meta device),
and a slot is installed along that axis, so the dense and MoE K/V
``(n_layers, B, ...)``, the SSM state ``(n_layers, B, ...)`` and the
hybrid's ``(n_groups, attn_every, B, ...)`` state and ``(n_groups, B,
...)`` K/V all serve through the same code.

Paged mode (``page_size=...``) replaces the per-slot stripes of every
leaf that grows with ``max_len`` (attention K/V) with a device-resident
page pool, e.g. ``(n_layers, num_pages, page_size, KV, D)``, plus a
``(num_slots, T)`` int32 page table (:mod:`repro_torch.serve.paging`);
every other leaf (conv and SSM state) keeps its per-slot form and its
own dtype.  Admission allocates just the pages a request needs,
identical prompt prefixes of the dense and hybrid families share pages
copy-on-write through a refcounted prefix cache (LRU-evicted under
pressure; a request that still does not fit is requeued), and decode
attention walks the table through the paged-attention kernel on the card
or a gather on the plain path, which is bitwise equal to contiguous
decode.  A model with no pageable leaf (pure SSM) degrades to the
contiguous engine with zero page gauges, as in the JAX engine.
Chunked prefill (``prefill_chunk=...``) ingests prompts longer than the
chunk one chunk per engine step, between decode dispatches, against a
private contiguous stripe that is installed when the last chunk lands;
it is refused for a model whose ``prefill_chunk`` is None (the MoE
family, whose batch-global routing is not chunk-invariant).  Quantized
params (``Model.quantize_weights``) pass through unchanged, and MoE
decode routes every slot's token, live or not, as in the JAX engine.

A request's ``frontend_embeds`` follow the JAX engine's rules: a vlm
prefix's P positions count toward the request's budget and its prompt
bucket (so a ``max_len`` of exactly prompt + P + generation is served),
an encdec source's frames do not (they fill the per-slot cross-attention
K/V, sized by ``cache_kwargs={"enc_len": ...}``, which paged encdec
serving requires); a request with a frontend shares no prefix page and
is never chunked.

``plan=`` takes a :class:`~repro_torch.plan.Plan` (or a saved one,
loaded by the caller) or ``"trace"``: :func:`repro_torch.plan.trace_model`
on the meta device resolves every kernel config the engine's buckets,
frontends and decode width need at construction, so serving never
consults the tuner; ``self.plan`` is the active plan.  A plan's misses
(e.g. the chunk shapes of chunked prefill, which the trace does not
cover, as in the JAX engine) resolve eagerly, at the first dispatch
of their shape; none ever resolves inside a CUDA-graph capture.
``validate=True`` runs the static analyzer over the active plan at
construction (:func:`repro_torch.analyze.lint_plan`) and, paged, over
the page geometry (:func:`repro_torch.analyze.lint_page_geometry`): an
error diagnostic raises ``ValueError`` before any request is admitted,
warnings are reported as a ``RuntimeWarning``, as in the JAX engine.

The int8 KV cache (``cache_kwargs={"quantize_kv": True}``) is refused:
paged with the JAX engine's error, contiguous because the reference
engine cannot serve it either (its prefill returns a cache without
``k_scale``/``v_scale`` leaves, so its first admission fails in
``_install``, ``src/repro/serve/engine.py:659``).  The cache itself is
the model's: ``init_cache(quantize_kv=True)`` and ``decode_step``.
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch import graphs, obs, resolve_device
from repro_torch.serve import sampling
from repro_torch.serve.paging import (TRASH_PAGE, OutOfPages, PageAllocator,
                                      PageGeometry, PrefixCache)
from repro_torch.serve.request import GenerationResult, Request, SlotState
from repro_torch.serve.stats import EngineStats

__all__ = ["ServeEngine", "lockstep_generate"]

# families whose prefill K/V at position i depends only on tokens <= i
# AND is batch-composition independent: the prefix-sharing soundness
# bar, the JAX engine's.  MoE is out (routing competes batch-globally,
# so a prefix's K/V depend on the rest of the prompt), encdec is out
# (every position also depends on the source frames).
_SHARE_FAMILIES = ("dense", "vlm", "hybrid")


def _host(x: torch.Tensor) -> np.ndarray:
    """THE device->host boundary.  Every readback the engine performs
    funnels through here, so tests can count the syncs per dispatch."""
    return x.cpu().numpy()


# THE engine clock: every latency the engine records reads it, so tests
# can substitute a fake clock.
_now = time.perf_counter


def _wait(device: torch.device) -> None:
    """Let the card finish what was queued, so that a host-clock interval
    covers the device work it launched (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _batch_axes(c1: dict[str, tuple], c2: dict[str, tuple]
                ) -> dict[str, int]:
    """Each leaf's batch axis, the one axis whose extent differs between
    its shapes at two batch sizes."""
    axes = {}
    for name, a in c1.items():
        diffs = [i for i, (x, y) in enumerate(zip(a, c2[name])) if x != y]
        if len(diffs) != 1:
            raise ValueError(f"cannot locate the batch axis of cache leaf "
                             f"{name!r}: shapes {a} vs {c2[name]}")
        axes[name] = diffs[0]
    return axes


class ServeEngine:
    """Continuous-batching engine over a ``Model`` bundle.

    ``model, params, ctx``: the ``build_model`` bundle, its parameters
    (on ``device``) and the execution context.  ``num_slots``: decode
    batch width.  ``max_len``: per-slot cache capacity.
    ``steps_per_dispatch``: decode iterations per block (K).
    ``bucket_sizes``: prompt pad lengths (default: powers of two from 8
    up to ``max_len``).  ``eos_id``: optional early-stop token.
    ``seed``: engine sampling seed.  ``device``: where the cache lives
    and the engine runs; ``None`` means the CUDA device (it raises when
    there is none).

    ``page_size``: tokens per KV page; ``None`` keeps the contiguous
    per-slot cache, an int (dividing ``max_len``) switches to the paged
    pool with prefix sharing.  ``num_pages``: pool size including the
    reserved trash page 0; the default ``num_slots * max_len //
    page_size + 1`` never runs short, a smaller pool oversubscribes
    (LRU prefix eviction, then requeueing until a decode retires).
    ``prefill_chunk``: ingest prompts longer than this that many tokens
    per engine step.  ``cache_kwargs`` are forwarded to
    ``model.init_cache`` (``enc_len`` for the encdec family, shared by
    every request; ``quantize_kv`` raises, see the module docstring).
    ``plan``: a :class:`~repro_torch.plan.Plan` or ``"trace"``;
    ``validate``: lint the plan (and the page geometry) at construction
    (see the module docstring).
    """

    def __init__(self, model, params, ctx, *, num_slots: int = 4,
                 max_len: int = 128, cache_dtype: torch.dtype = torch.float32,
                 steps_per_dispatch: int = 1,
                 bucket_sizes: Sequence[int] | None = None,
                 eos_id: int | None = None, seed: int = 0, device=None,
                 page_size: int | None = None,
                 num_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 cache_kwargs: dict | None = None, plan=None,
                 validate: bool = False):
        self._cache_kw = dict(cache_kwargs or {})
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.cache_dtype = cache_dtype
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        self.eos_id = eos_id
        self.seed = int(seed)
        self.page_size = None if page_size is None else int(page_size)
        self._chunk = None if prefill_chunk is None else int(prefill_chunk)
        if self._chunk is not None and self._chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if self._chunk is not None and model.prefill_chunk is None:
            raise ValueError(
                f"family {model.cfg.family!r} does not support chunked "
                "prefill (Model.prefill_chunk is None: its prompt state "
                "is not chunk-invariant)")
        if bucket_sizes is None:
            bucket_sizes, b = [], 8
            while b < max_len:
                bucket_sizes.append(b)
                b *= 2
            bucket_sizes.append(max_len)
        self.bucket_sizes = tuple(sorted(set(int(b) for b in bucket_sizes)))

        if plan is not None:
            if isinstance(plan, str) and plan == "trace":
                plan = self._trace_plan(model, ctx, cache_dtype)
            ctx = ctx.with_plan(plan)
        self.ctx = ctx
        self.plan = ctx.plan
        if validate:
            self._validate_plan()

        # each cache leaf's batch axis, probed once from two batch sizes
        # on the meta device (shapes only, nothing allocated)
        self._axes = _batch_axes(self._shapes(1, self.max_len),
                                 self._shapes(2, self.max_len))
        self._geom: PageGeometry | None = None
        self._paged: set[str] = set()
        self._pages_active = False
        if self.page_size is None:
            if self._cache_kw.get("quantize_kv"):
                raise ValueError(
                    "ServeEngine: the int8 KV cache (quantize_kv) is not "
                    "served: the reference engine cannot install it (its "
                    "prefill returns a cache without k_scale/v_scale "
                    "leaves, so its first admission fails in _install, "
                    "src/repro/serve/engine.py:659); decode it with "
                    "init_cache(quantize_kv=True) and Model.decode")
            self.cache = model.init_cache(self.num_slots, self.max_len,
                                          cache_dtype, device=self.device,
                                          **self._cache_kw)
        else:
            self._init_paging(num_pages)
            if validate:
                self._validate_pages()
        self.cache["pos"] = torch.zeros((self.num_slots,), dtype=torch.int32,
                                        device=self.device)
        # chunked admissions in flight: slot -> parked state
        self._chunking: dict[int, dict] = {}
        # per-slot sampling state: threefry key data on the device (set
        # at admission, carried through the block) and host mirrors of
        # the knobs
        self._keys = sampling.make_keys(self.num_slots, self.device)
        self._temp = np.zeros((self.num_slots,), np.float32)
        self._topk = np.zeros((self.num_slots,), np.int32)
        self._topp = np.ones((self.num_slots,), np.float32)
        # the block's per-dispatch operands, rows tok, done, budget,
        # top_k, temp, top_p: one int32 tensor (the floats' bits) so that
        # one host->device copy loads them, staged through pinned memory
        # on the card
        self._ops = torch.zeros((6, self.num_slots), dtype=torch.int32,
                                device=self.device)
        self._ops_host = torch.zeros((6, self.num_slots), dtype=torch.int32,
                                     pin_memory=self.device.type == "cuda")
        # greedy_only -> (graph, its token tile, the launches it replays)
        self._graphs: dict[bool, tuple] = {}
        # the prefill programs: key -> static inputs (made at the key's
        # first use), key -> (graph, outputs, launches) once captured, and
        # the one memory pool of their graphs (made at the first capture)
        self._pf_in: dict[tuple, dict] = {}
        self._pf_graphs: dict[tuple, tuple] = {}
        self._pf_pool = None
        # dtype -> the batch-1 cache the programs write (_batch1), and
        # the chunked admission whose rows the chunk stripe holds
        self._b1: dict[torch.dtype, dict] = {}
        self._stripe_slot: int | None = None
        #: one record a captured graph: variant, pool bytes, capture s
        self.captures: list[dict] = []

        self._pending: collections.deque[Request] = collections.deque()
        self._slots: list[SlotState | None] = [None] * self.num_slots
        self._results: dict[int, GenerationResult] = {}
        self._step = 0
        self.stats = EngineStats(num_slots=self.num_slots)
        self._submit_t: dict[int, float] = {}
        self._last_prefill_s = 0.0
        self._last_dispatch_s = 0.0

    def _trace_plan(self, model, ctx, cache_dtype):
        """Resolve every kernel config this engine will need, ahead of
        time: one meta-device prefill per bucket size (batch 1, exactly
        the admission shape, with the family's frontend) plus one decode
        at the slot width, with the engine's real params (moved to the
        meta device: their dtypes and layouts, no data)."""
        from repro_torch.plan import trace_model
        cfg = model.cfg
        n_front = 0
        if cfg.family == "encdec":
            front = (1, int(self._cache_kw.get("enc_len", 8)), cfg.d_model)
        elif getattr(cfg, "frontend", None):
            front = (1, cfg.frontend_tokens, cfg.d_model)
            n_front = cfg.frontend_tokens
        else:
            front = None
        shapes, seen = [], set()
        for b in self.bucket_sizes:
            sb = min(b, self.max_len - n_front)
            if sb < 1 or sb in seen:
                continue
            seen.add(sb)
            bs = {"tokens": ((1, sb), torch.int32),
                  "lengths": ((1,), torch.int32)}
            if front is not None:
                bs["frontend_embeds"] = (front, ctx.dtype)
            shapes.append(bs)
        return trace_model(model, shapes, ctx, max_len=self.max_len,
                           modes=("prefill", "decode"),
                           decode_batch=self.num_slots,
                           cache_dtype=cache_dtype,
                           cache_kwargs=self._cache_kw, params=self.params)

    def _validate_plan(self) -> None:
        """Load-time plan verification (``validate=True``): the static
        analyzer (:func:`repro_torch.analyze.lint_plan`) over the active
        plan; a plan with a slot-reuse hazard, an int8-in-int8 entry or
        an over-budget tile is rejected before the first request is
        admitted; warnings are surfaced but do not block."""
        from repro_torch.analyze import lint_plan
        report = lint_plan(self.plan)
        if report.errors:
            raise ValueError(
                "ServeEngine(validate=True): the plan failed static "
                "analysis:\n" + "\n".join(d.format() for d in report.errors))
        if report.warnings:
            warnings.warn(
                "ServeEngine: plan analysis warnings:\n"
                + "\n".join(d.format() for d in report.warnings),
                RuntimeWarning, stacklevel=3)

    def _validate_pages(self) -> None:
        """Load-time page-geometry verification (``validate=True``):
        :func:`repro_torch.analyze.lint_page_geometry` rejects a page
        size that does not tile the plan's attention KV blocks
        (ZS-L008), a table too short for ``max_len`` (ZS-S008) or a paged
        attention block over the shared-memory budget (ZS-S004)."""
        from repro_torch.analyze import lint_page_geometry
        cfg = self.model.cfg
        report = lint_page_geometry(
            self._geom.page_size, self._geom.table_len,
            max_len=self.max_len, plan=self.plan,
            head_dim=cfg.resolved_head_dim,
            rep=cfg.n_heads // max(1, cfg.n_kv_heads),
            dtype_bytes=torch.empty((), dtype=self.cache_dtype)
            .element_size())
        if report.errors:
            raise ValueError(
                "ServeEngine(validate=True): page geometry failed static "
                "analysis:\n" + "\n".join(d.format() for d in report.errors))

    def _shapes(self, batch: int, max_len: int) -> dict[str, tuple]:
        """The shape of every cache leaf but ``pos`` at ``batch`` and
        ``max_len`` (``init_cache`` on the meta device)."""
        c = self.model.init_cache(batch, max_len, self.cache_dtype,
                                  device="meta", **self._cache_kw)
        return {k: tuple(v.shape) for k, v in c.items() if k != "pos"}

    # -- paged KV cache --------------------------------------------------
    def _init_paging(self, num_pages: int | None) -> None:
        """Build the page pool in place of the contiguous cache.

        Which leaves page is probed, not hard-coded: ``init_cache`` is
        evaluated on the meta device at ``max_len`` and at ``max_len +
        page_size``, and a leaf that grows by exactly ``page_size`` on the
        axis right of its batch axis is sequence-extent KV and becomes a
        ``(..., num_pages, page_size, ...)`` pool; a leaf that does not
        grow keeps its per-slot form and dtype.  With no pageable leaf
        (pure SSM) the engine runs contiguous, with zero page gauges."""
        ps = self.page_size
        if ps < 1 or self.max_len % ps:
            raise ValueError(
                f"page_size {ps} must be >= 1 and divide max_len "
                f"{self.max_len}")
        if self._cache_kw.get("quantize_kv"):
            raise ValueError("paged serving does not support quantize_kv "
                             "(int8 page pools are not implemented)")
        if self.model.cfg.family == "encdec" and "enc_len" not in \
                self._cache_kw:
            raise ValueError(
                "paged encdec serving requires an explicit enc_len in "
                "cache_kwargs: with enc_len defaulting to max_len the "
                "fixed cross-attention extent would probe as a pageable "
                "sequence axis")
        T = self.max_len // ps
        if num_pages is None:
            num_pages = self.num_slots * T + 1   # +1: the trash page
        self._geom = PageGeometry(ps, int(num_pages), T)
        self._alloc = PageAllocator(self._geom)
        self._prefix = PrefixCache(self._alloc)
        self._slot_pages: list[list[int]] = [[] for _ in
                                             range(self.num_slots)]

        base = self._shapes(1, self.max_len)
        grown = self._shapes(1, self.max_len + ps)
        # the leaves that page (their batch axis becomes the page axis,
        # the sequence axis right of it the page's rows)
        for name, shape in base.items():
            bax = self._axes[name]
            diffs = [i for i, (x, y) in enumerate(zip(shape, grown[name]))
                     if x != y]
            if not diffs:
                continue
            if diffs != [bax + 1] or grown[name][bax + 1] - shape[bax + 1] \
                    != ps:
                raise ValueError(
                    f"cannot page cache leaf {name!r}: shapes {shape} vs "
                    f"{grown[name]} (expected growth of {ps} on axis "
                    f"{bax + 1}, right of its batch axis)")
            self._paged.add(name)
        self._pages_active = bool(self._paged)
        self.cache = self.model.init_cache(self.num_slots, self.max_len,
                                           self.cache_dtype, device="meta",
                                           **self._cache_kw)
        for name, meta in list(self.cache.items()):
            shape, dtype = list(meta.shape), meta.dtype
            if name in self._paged:
                bax = self._axes[name]
                shape[bax], shape[bax + 1] = self._geom.num_pages, ps
            self.cache[name] = torch.zeros(shape, dtype=dtype,
                                           device=self.device)
        if self._pages_active:
            # all-zeros table: every slot starts parked on the trash page
            self.cache["page_table"] = torch.zeros(
                (self.num_slots, T), dtype=torch.int32, device=self.device)

    def _alloc_pages(self, n: int) -> list[int]:
        """Atomic n-page allocation, evicting LRU prefix entries under
        pressure; raises :class:`OutOfPages` only once the prefix cache
        is empty too."""
        while True:
            try:
                return self._alloc.alloc(n)
            except OutOfPages:
                if not self._prefix.evict_lru():
                    raise

    def _page_gauges(self) -> None:
        s = self.stats
        s.pages_in_use = max(s.pages_in_use, self._alloc.in_use)
        counts = collections.Counter(
            p for pages in self._slot_pages for p in pages)
        s.pages_shared = max(
            s.pages_shared, sum(1 for c in counts.values() if c >= 2))

    @property
    def pages_in_use_now(self) -> int:
        """Current page-pool occupancy (0 for the contiguous cache): an
        instantaneous gauge, unlike ``stats.pages_in_use`` (the peak)."""
        return self._alloc.in_use if self._geom is not None else 0

    # ------------------------------------------------------------------
    def _decode_block(self, tok: np.ndarray, done: np.ndarray,
                      budget: np.ndarray, *, greedy_only: bool
                      ) -> torch.Tensor:
        """One K-step block from the (num_slots,) host vectors of this
        dispatch -> the (num_slots, K) token tile on the device, with no
        host sync.  On a CUDA device the block is the variant's CUDA
        graph, captured after the variant's first (eager) dispatch."""
        self._ops_host.numpy()[:] = (tok, done, budget, self._topk,
                                     self._temp.view(np.int32),
                                     self._topp.view(np.int32))
        # the host rewrites the staging buffer only after the dispatch's
        # read of the tile, so the copy may run behind the host
        self._ops.copy_(self._ops_host, non_blocking=True)
        return self._run(self._graphs, greedy_only,
                         lambda: self._block(greedy_only), self._capture)

    def _run(self, table: dict, key, body, capture):
        """``body()`` as a program of static buffers: eagerly on the CPU;
        on a CUDA device the replay of ``table[key]``, or, at the key's
        first use, ``body()`` eagerly (which builds the kernels and
        resolves the plan's call sites) and then ``capture(key)``."""
        if self.device.type != "cuda":
            return body()
        if key not in table:
            out = body()
            capture(key)
            return out
        return graphs.replay(table[key])

    def _capture(self, greedy_only: bool) -> None:
        """Capture the variant's block as a CUDA graph of the engine's
        static buffers (:func:`repro_torch.graphs.capture`), recorded in
        ``captures``."""
        self._graphs[greedy_only] = graphs.capture(
            lambda: self._block(greedy_only), self.device,
            "greedy" if greedy_only else "sampled", self.captures)

    def _capture_prefill(self, key: tuple) -> None:
        """Capture the prefill program of ``key`` (as :meth:`_capture`)
        into the pool every prefill and chunk graph of this engine shares.
        Sharing is safe only because each replay's outputs are consumed
        before another of these graphs replays: ``_admit`` installs the
        batch-1 cache and samples from the logits at once, and the last
        chunk's logits are copied out.  The caches the graphs write are
        the engine's batch-1 buffers (:meth:`_batch1`), outside the pool,
        so the pool holds one program's working memory at a time, not a
        cache a graph."""
        if self._pf_pool is None:
            self._pf_pool = torch.cuda.graph_pool_handle()
        if key[0] == "chunk":
            variant = f"prefill_chunk:{self._chunk}"
        else:
            variant = f"prefill:{key[1]}" + ("+frontend" if len(key) > 2
                                             else "")
        self._pf_graphs[key] = graphs.capture(
            lambda: self._prefill_program(key), self.device, variant,
            self.captures, pool=self._pf_pool)

    def _prefill_program(self, key: tuple):
        """The prefill program of ``key`` on its static inputs
        (``self._pf_in[key]``) -> (logits, cache): a batch-1
        ``Model.prefill`` at a prompt bucket (``("prefill", bucket)``, and
        the frontend's shape and dtype) into the ``ctx.dtype`` batch-1
        buffer, or one chunk (``("chunk",)``) against the chunk stripe,
        the ``cache_dtype`` one."""
        buf = self._pf_in[key]
        if key[0] == "chunk":
            return self.model.prefill_chunk(
                self.params, buf["tokens"], self.ctx,
                cache=self._batch1(self.cache_dtype), offset=buf["offset"],
                lengths=buf["lengths"])
        return self.model.prefill(self.params, buf, self.ctx, self.max_len,
                                  cache=self._prefill_cache())

    def _prefill_cache(self) -> dict | None:
        """The cache a prefill program writes: the ``ctx.dtype`` batch-1
        buffer (None: a fresh one each call)."""
        return self._batch1(self.ctx.dtype)

    def _batch1(self, dtype: torch.dtype) -> dict:
        """The engine's batch-1 cache in ``dtype`` (without ``pos``), made
        at its first use, outside any graph's pool.  The prefill programs
        write theirs in ``ctx.dtype`` (what ``Model.prefill`` returns) and
        the chunks theirs in ``cache_dtype`` (the stripe's dtype, which
        the chunk's attention reads back): one buffer where the two
        agree."""
        buf = self._b1.get(dtype)
        if buf is None:
            buf = self.model.init_cache(1, self.max_len, dtype,
                                        device=self.device, **self._cache_kw)
            del buf["pos"]
            self._b1[dtype] = buf
        return buf

    def _take_stripe(self, slot: int | None) -> None:
        """Hand the chunk stripe to the chunked admission parked in
        ``slot`` (None: to a prefill about to overwrite it).  The rows the
        admission that held it has ingested are saved into its parked
        state, and the new holder's restored, with its later rows zeroed,
        as in a stripe of its own.  Only dense and vlm chunk: the stripe's
        leaves are ``k`` and ``v``, positions on axis 2."""
        held = self._stripe_slot
        if held == slot:
            return
        stripe = self._batch1(self.cache_dtype)
        st = self._chunking.get(held)
        if st is not None and st["off"]:
            st["rows"] = {n: stripe[n][:, :, :st["off"]].clone()
                          for n in ("k", "v")}
        if slot is not None:
            st = self._chunking[slot]
            rows = st.pop("rows", {})
            for n in ("k", "v"):
                stripe[n][:, :, st["off"]:].zero_()
                if n in rows:
                    stripe[n][:, :, :st["off"]].copy_(rows[n])
        self._stripe_slot = slot

    def _block(self, greedy_only: bool) -> torch.Tensor:
        """K decode+sample iterations over all slots, reading the static
        operands (``self._ops``, ``self._keys``, the cache) ->
        (num_slots, K) int64 tokens.

        Frozen (done) rows re-feed their last token, keep their key and
        stop consuming budget; their cache rows still see writes, which
        land in their own stripe (clamped in bounds) or, paged, in their
        own pages or the trash page, and are overwritten at the slot's
        next admission.  The last operations copy the new ``pos`` (and
        any cache leaf ``decode`` returned anew) and keys back into the
        static tensors, so a replay leaves the engine where this loop
        does.  ``greedy_only`` is the argmax specialisation of an
        all-greedy slot pool: no sort, no draw, keys untouched.

        Its regions (:func:`repro_torch.obs.region`), which map the
        graph's device nodes: ``decode.model`` (the model's step),
        ``decode.sample`` (the sampler) and ``decode.state`` (the
        operands unpacked, the keys, tokens, budgets and done masks
        updated, the closing copies into the static tensors)."""
        model, ctx, eos = self.model, self.ctx, self.eos_id
        with obs.region("decode.state"):
            tok, done, budget, topk, temp, topp = self._ops
            tok, done = tok.long(), done.bool()
            temp, topp = temp.view(torch.float32), topp.view(torch.float32)
        keys, cache = self._keys, dict(self.cache)
        out = []
        for _ in range(self.steps_per_dispatch):
            with obs.region("decode.model"):
                logits, cache = model.decode(self.params, cache,
                                             tok[:, None], ctx)
            with obs.region("decode.sample"):
                if greedy_only:
                    nxt = sampling.greedy(logits[:, -1])
                else:
                    keys2, nxt = sampling.sample(logits[:, -1], keys, temp,
                                                 topk, topp)
            with obs.region("decode.state"):
                if not greedy_only:
                    keys = torch.where(done[:, None], keys, keys2)
                nxt = torch.where(done, tok, nxt.long())
                budget = budget - (~done).to(torch.int32)
                newly = budget <= 0
                if eos is not None:
                    newly = newly | (nxt == eos)
                done = done | newly
                tok = nxt
                out.append(nxt)
        with obs.region("decode.state"):
            for name, t in cache.items():
                if t is not self.cache[name]:
                    self.cache[name].copy_(t)
            if keys is not self._keys:
                self._keys.copy_(keys)
            return torch.stack(out, dim=1)

    # ------------------------------------------------------------------
    def _n_front(self, req: Request) -> int:
        """Cache positions a request's frontend takes: a vlm prefix's P
        rows; an encdec source's frames fill the cross K/V instead."""
        if req.frontend_embeds is None or self.model.cfg.family == "encdec":
            return 0
        return int(np.shape(req.frontend_embeds)[0])

    def submit(self, request: Request) -> None:
        n_prompt = len(request.prompt) + self._n_front(request)
        budget = n_prompt + request.max_new_tokens
        if self._geom is not None:
            # checked before the budget: a prompt that cannot even be
            # stored gets the structural error, not the generic one
            cap = self._geom.table_len * self._geom.page_size
            if n_prompt > cap:
                raise ValueError(
                    f"request {request.rid}: prompt ({n_prompt} "
                    f"tokens) alone exceeds the page-table capacity {cap} "
                    f"({self._geom.table_len} pages x "
                    f"{self._geom.page_size} tokens/page)")
        if budget > self.max_len:
            raise ValueError(f"request {request.rid}: prompt + generation "
                             f"({budget}) exceeds max_len {self.max_len}")
        if request.rid in self._results or any(
                s is not None and s.request.rid == request.rid
                for s in self._slots) or any(
                r.rid == request.rid for r in self._pending):
            raise ValueError(f"duplicate request id {request.rid}")
        self._submit_t[request.rid] = _now()
        self._pending.append(request)

    @property
    def idle(self) -> bool:
        return (not self._pending and not self._chunking
                and all(s is None for s in self._slots))

    # -- the hooks a router reads (repro_torch.serve.cluster) -------------
    @property
    def free_slots(self) -> int:
        """Slots neither occupied nor parked on a chunked admission."""
        return sum(1 for i, s in enumerate(self._slots)
                   if s is None and i not in self._chunking)

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet placed into a slot."""
        return len(self._pending)

    def pop_results(self) -> dict[int, GenerationResult]:
        """Hand over (and clear) the finished results.  A router drains
        them after every replica step; a rid stays live against duplicate
        submission only until its result is popped."""
        out, self._results = self._results, {}
        return out

    def _bucket(self, n: int, limit: int) -> int:
        """Smallest bucket >= n, clamped to ``limit`` (``max_len`` less
        the request's frontend positions: a prefix eats into the bucket,
        not into the prompt; ``submit`` ensures n <= limit)."""
        for b in self.bucket_sizes:
            if b >= n:
                return min(b, limit)
        raise ValueError(f"prompt length {n} exceeds the largest bucket "
                         f"{self.bucket_sizes[-1]}")

    def _admit(self, req: Request, slot: int) -> int:
        """Batch-1 prefill into ``slot``; returns the first token.  Raises
        :class:`OutOfPages` (paged mode, pool exhausted even after prefix
        eviction) before any engine state changes, so the caller can
        requeue the request.

        Its four sub-spans of ``serve.admit``, each with ``rid``:
        ``serve.admit.load`` (the static inputs written),
        ``serve.admit.prefill`` (the program's replay launched),
        ``serve.admit.install`` (the cache installed into the slot) and
        ``serve.admit.first_token`` (the first token sampled and read).
        Nothing here waits for the card but the last one's host read,
        so the first three time the host's issue of their work, and the
        device work they queue lands in ``serve.admit.first_token``."""
        rid = req.rid
        with obs.span("serve.admit.load", rid=rid):
            key = self._load_prefill(req)
        with obs.span("serve.admit.prefill", rid=rid):
            logits, cache1 = self._run(self._pf_graphs, key,
                                       lambda: self._prefill_program(key),
                                       self._capture_prefill)
        with obs.span("serve.admit.install", rid=rid):
            self._install(req, slot, cache1,
                          len(req.prompt) + self._n_front(req))
        with obs.span("serve.admit.first_token", rid=rid):
            return self._first_token(req, slot, logits)

    def _load_prefill(self, req: Request) -> tuple:
        """Write ``req`` into the static inputs of its prefill program
        (made at the key's first use) -> the key: ``("prefill",
        bucket)``, with the frontend's shape and dtype where it has
        one."""
        n, n_front = len(req.prompt), self._n_front(req)
        sb = self._bucket(n, self.max_len - n_front)
        if self.ctx.dtype == self.cache_dtype:
            self._take_stripe(None)         # the prefill's buffer is it
        fe = (None if req.frontend_embeds is None
              else torch.as_tensor(req.frontend_embeds))
        key = ("prefill", sb) if fe is None else \
            ("prefill", sb, tuple(fe.shape), fe.dtype)
        buf = self._pf_in.get(key)
        if buf is None:
            buf = self._pf_in[key] = {
                "tokens": torch.zeros((1, sb), dtype=torch.long,
                                      device=self.device),
                "lengths": torch.zeros((1,), dtype=torch.int32,
                                       device=self.device)}
            if fe is not None:
                buf["frontend_embeds"] = torch.zeros(
                    (1, *fe.shape), dtype=fe.dtype, device=self.device)
        # every buffer rewritten whole, zeros past the prompt as JAX
        # pads: a shorter prompt after a longer one in the bucket must
        # not see the longer one's tail (its K/V land in the cache past
        # pos, and not every family's pass reads the mask)
        toks = torch.zeros((1, sb), dtype=torch.long)
        toks[0, :n] = torch.tensor(req.prompt, dtype=torch.long)
        buf["tokens"].copy_(toks)
        buf["lengths"].fill_(n)
        if fe is not None:
            buf["frontend_embeds"].copy_(fe[None])
        return key

    def _install(self, req: Request, slot: int, cache1,
                 n_prompt: int) -> None:
        """Insert a prefilled batch-1 contiguous cache into ``slot``: its
        pages first (paged mode, :meth:`_install_pages`, which raises
        :class:`OutOfPages` before it changes anything), then every leaf
        that does not page, copied into the slot along its batch axis in
        the leaf's own dtype, and ``pos``."""
        if self._pages_active:
            self._install_pages(req, slot, cache1, n_prompt)
        for name, bax in self._axes.items():
            if name not in self._paged:
                dst = self.cache[name]
                dst.select(bax, slot).copy_(cache1[name].select(bax, 0))
        self.cache["pos"][slot] = cache1["pos"][0]

    def _install_pages(self, req: Request, slot: int, cache1,
                       n_prompt: int) -> None:
        """The paged leaves of an admission (``n_prompt`` cache positions,
        a vlm prefix's included).  For the sharing families
        (``_SHARE_FAMILIES``), and a request without a frontend, retain the published prefix pages the prompt
        hits; allocate the rest (evicting cold prefixes under pressure),
        copy the stripe's pages into the pool at ``write_ids`` (the trash
        page for shared prefix pages, which already hold these values and
        must not be rewritten, and for unallocated tail pages), point the
        slot's table row at ``table_ids``, and, sharing, publish the
        prompt's full pages for later admissions.  Other families' pages
        are all private."""
        geom = self._geom
        T, ps = geom.table_len, geom.page_size
        t_alloc = geom.pages_for(min(n_prompt + req.max_new_tokens,
                                     self.max_len))
        # a frontend prefix's K/V are not a function of the prompt tokens
        share = (self.model.cfg.family in _SHARE_FAMILIES
                 and req.frontend_embeds is None)
        shared: list[int] = []
        if share:
            _, shared = self._prefix.lookup(req.prompt)
            shared = shared[:t_alloc]
            # hold the hits before allocating: eviction under pressure
            # must not recycle the very pages this admission reuses
            for p in shared:
                self._alloc.retain(p)
        try:
            own = self._alloc_pages(t_alloc - len(shared))
        except OutOfPages:
            self._alloc.release_all(shared)
            raise
        pages = shared + own
        write_ids = np.full((T,), TRASH_PAGE, np.int64)
        table_ids = np.full((T,), TRASH_PAGE, np.int32)
        table_ids[:t_alloc] = pages
        write_ids[len(shared):t_alloc] = own
        write_ids = torch.from_numpy(write_ids).to(self.device)
        for name in self._paged:
            # (..., 1, max_len, ...) -> (..., T, ps, ...) on the pool axes
            bax = self._axes[name]
            src = cache1[name].select(bax, 0).unflatten(bax, (T, ps))
            dst = self.cache[name]
            dst.index_copy_(bax, write_ids, src.to(dst.dtype))
        self.cache["page_table"][slot] = torch.from_numpy(table_ids).to(
            self.device)
        self._slot_pages[slot] = pages
        if share:
            self._prefix.publish(req.prompt, pages)
        self._page_gauges()

    def _request_key(self, req: Request) -> torch.Tensor:
        """(2,) key data of the request's sample chain (on the host):
        ``PRNGKey(req.seed)``, or ``fold_in(PRNGKey(engine seed), rid)``
        for a request without a seed, as in the JAX engine."""
        if req.seed is not None:
            return sampling.request_key(req.seed)
        return sampling.fold_in(sampling.request_key(self.seed), req.rid)

    def _first_token(self, req: Request, slot: int, logits) -> int:
        """Sample the first token with the request's own knobs and key
        (one sync per admission); the advanced key parks in the slot's
        row of the device keys.  A greedy request only advances its key
        (one split, on the host): its token never reads it."""
        key = self._request_key(req)[None]
        dev = self.device
        if req.temperature > 0:
            key, tok = sampling.sample(
                logits[:, -1], key.to(dev),
                torch.full((1,), req.temperature, device=dev),
                torch.full((1,), req.top_k, dtype=torch.int32, device=dev),
                torch.full((1,), req.top_p, device=dev))
        else:
            key, tok = sampling.split(key)[:, 0], sampling.greedy(
                logits[:, -1])
        self._keys[slot] = key[0].to(dev)
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        return int(_host(tok)[0])

    def _retire(self, slot: int) -> None:
        st = self._slots[slot]
        self._results[st.request.rid] = GenerationResult(
            rid=st.request.rid, prompt_len=len(st.request.prompt),
            tokens=st.tokens, admitted_step=st.admitted_step,
            finished_step=self._step, queue_wait_s=st.queue_wait_s,
            ttft_s=st.ttft_s)
        self._slots[slot] = None
        self.stats.retired += 1
        if self._geom is not None and self._slot_pages[slot]:
            # order matters: point the table row at the trash page first,
            # then release the pages, so that a page handed to another
            # request at once never sees this row's frozen decode writes
            self.cache["page_table"][slot] = TRASH_PAGE
            self._alloc.release_all(self._slot_pages[slot])
            self._slot_pages[slot] = []
        obs.event("serve.retire", rid=st.request.rid, slot=slot,
                  tokens=len(st.tokens), steps=self._step - st.admitted_step)

    def _done(self, st: SlotState, tok: int) -> bool:
        return (len(st.tokens) >= st.request.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id))

    # -- chunked prefill -------------------------------------------------
    def _chunkable(self, req: Request) -> bool:
        return (self._chunk is not None and req.frontend_embeds is None
                and len(req.prompt) > self._chunk)

    def _start_chunking(self, req: Request, slot: int, queue_wait: float,
                        t_submit: float) -> None:
        """Park ``req`` in ``slot`` as an in-flight chunked admission: its
        prompt is ingested ``prefill_chunk`` tokens per engine step into
        the engine's chunk stripe (:meth:`_take_stripe` hands it from one
        admission in flight to another), installed when the last chunk
        lands."""
        self._chunking[slot] = {
            "req": req, "off": 0, "n": len(req.prompt),
            "queue_wait": queue_wait, "t_submit": t_submit,
        }

    def _load_chunk(self, tokens: Sequence[int], offset: int) -> tuple:
        """Write one chunk (``tokens`` from absolute position ``offset``,
        zeros after them) into the static inputs of the chunk program
        (made at its first use) -> its key."""
        key = ("chunk",)
        buf = self._pf_in.get(key)
        if buf is None:
            dev = self.device
            buf = self._pf_in[key] = {
                "tokens": torch.zeros((1, self._chunk), dtype=torch.long,
                                      device=dev),
                "offset": torch.zeros((1,), dtype=torch.int32, device=dev),
                "lengths": torch.zeros((1,), dtype=torch.int32, device=dev)}
        toks = torch.zeros((1, self._chunk), dtype=torch.long)
        toks[0, :len(tokens)] = torch.tensor(list(tokens), dtype=torch.long)
        buf["tokens"].copy_(toks)
        buf["offset"].fill_(offset)
        buf["lengths"].fill_(offset + len(tokens))
        return key

    def _advance_chunk(self, slot: int) -> list[tuple[int, int]]:
        """Ingest one more chunk of the admission parked in ``slot``; on
        the last one, install the stripe, sample the first token and
        activate the slot.  Returns the streamed events (empty until the
        first token).  When the pool is full after the last chunk the
        parked state is kept and the install retried next step, unless
        nothing is active to ever free a page."""
        st = self._chunking[slot]
        req: Request = st["req"]
        if "logits" not in st:
            off, n = st["off"], st["n"]
            end = min(off + self._chunk, n)
            t0 = _now()
            with obs.span("serve.prefill_chunk", rid=req.rid, slot=slot,
                          step=self._step, offset=off, end=end,
                          decoding=self._decoding()):
                self._take_stripe(slot)
                key = self._load_chunk(req.prompt[off:end], off)
                logits, _ = self._run(self._pf_graphs, key,
                                      lambda: self._prefill_program(key),
                                      self._capture_prefill)
                # unlike the JAX engine, which leaves the chunk in
                # flight, wait for it: a chunk that is not the last reads
                # nothing back, so without the wait its device time would
                # land in the next decode dispatch's ``decode_s``
                _wait(self.device)
            dt = _now() - t0
            self.stats.prefill_s += dt
            self.stats.prefill_chunks += 1
            self._last_prefill_s = max(self._last_prefill_s, dt)
            st["off"] = end
            if end < n:
                return []
            # a replay's logits live in the graphs' shared pool, and the
            # install may wait for pages across engine steps: a copy
            st["logits"] = logits.clone()
        try:
            with obs.span("serve.admit.install", rid=req.rid):
                self._take_stripe(slot)
                cache1 = {**self._batch1(self.cache_dtype),
                          "pos": torch.full((1,), st["n"], dtype=torch.int32,
                                            device=self.device)}
                self._install(req, slot, cache1, st["n"])
        except OutOfPages:
            if not any(s is not None for s in self._slots):
                raise
            return []
        with obs.span("serve.admit.first_token", rid=req.rid):
            tok = self._first_token(req, slot, st["logits"])
        del self._chunking[slot]
        self._stripe_slot = None
        self.stats.prefill_tokens += st["n"]
        self.stats.admitted += 1
        ttft = _now() - st["t_submit"]
        self.stats.queue_wait_s.append(st["queue_wait"])
        self.stats.ttft_s.append(ttft)
        slot_st = SlotState(request=req, tokens=[tok], next_token=tok,
                            admitted_step=self._step,
                            queue_wait_s=st["queue_wait"], ttft_s=ttft)
        self._slots[slot] = slot_st
        if self._done(slot_st, tok):
            self._retire(slot)
        return [(req.rid, tok)]

    # ------------------------------------------------------------------
    def step(self) -> list[tuple[int, int]]:
        """Chunks of in-flight chunked admissions, admissions, then one
        decode block (K iterations, one host sync).  Returns streamed
        (rid, token) events in emission order.

        Its spans: ``serve.step`` around the whole step, which names the
        host's time between its sub-spans; inside it ``serve.schedule``
        (everything up to the dispatch, :meth:`_schedule`; inside it
        ``serve.prefill_chunk`` and ``serve.admit``, with ``decoding``,
        the live slots they hold back, and the ``serve.admit.*``
        sub-spans), ``serve.dispatch`` (the block, ending at its host
        read) and ``serve.drain`` (its tokens drained and the finished
        requests retired)."""
        events: list[tuple[int, int]] = []
        self._step += 1
        self._last_prefill_s = 0.0
        self._last_dispatch_s = 0.0
        with obs.span("serve.step", step=self._step):
            self._step_body(events)
        return events

    def _step_body(self, events: list) -> None:
        """The body of :meth:`step`, its streamed events appended to
        ``events``."""
        with obs.span("serve.schedule", step=self._step):
            ops = self._schedule(events)
        if ops is None:
            return
        active, toks, done, budget, greedy_only = ops

        K = self.steps_per_dispatch
        t0 = _now()
        with obs.span("serve.dispatch", step=self._step, k=K,
                      active=len(active),
                      variant="greedy" if greedy_only else "sampled"):
            block = self._decode_block(toks, done, budget,
                                       greedy_only=greedy_only)
            block = _host(block)      # THE one sync of this dispatch
        dt = _now() - t0
        self._last_dispatch_s = dt
        self.stats.decode_s += dt
        self.stats.decode_steps += K
        self.stats.dispatches += 1
        self.stats.dispatch_occupancy.append(len(active) / self.num_slots)
        per_token_s = dt / K

        # drain step-major so events are ordered like K single steps
        with obs.span("serve.drain", step=self._step):
            for k in range(K):
                for i in active:
                    st = self._slots[i]
                    if st is None:
                        continue
                    tok = int(block[i, k])
                    st.tokens.append(tok)
                    st.next_token = tok
                    self.stats.decode_tokens += 1
                    self.stats.token_latency_s.append(per_token_s)
                    events.append((st.request.rid, tok))
                    if self._done(st, tok):
                        self._retire(i)

    def _schedule(self, events: list) -> tuple | None:
        """The step up to its dispatch: one chunk of each in-flight
        chunked admission, queued requests admitted into free slots
        (their streamed events appended to ``events``), then the live
        slots' operand vectors -> (active, toks, done, budget,
        greedy_only), or None where no slot decodes."""
        # one chunk of each in-flight chunked admission per step, between
        # decode dispatches, so a long prompt never blocks the slots that
        # are already decoding
        for slot in sorted(self._chunking):
            events.extend(self._advance_chunk(slot))

        blocked = False
        for slot in range(self.num_slots):
            if (self._slots[slot] is not None or slot in self._chunking
                    or not self._pending):
                continue
            req = self._pending.popleft()
            t0 = _now()
            queue_wait = t0 - self._submit_t.pop(req.rid, t0)
            if self._chunkable(req):
                self._start_chunking(req, slot, queue_wait, t0 - queue_wait)
                events.extend(self._advance_chunk(slot))
                continue
            try:
                with obs.span("serve.admit", rid=req.rid, slot=slot,
                              step=self._step, prompt_len=len(req.prompt),
                              decoding=self._decoding()):
                    tok = self._admit(req, slot)
            except OutOfPages:
                # pool exhausted: requeue at the front and stop admitting;
                # active slots will retire and free pages
                self._submit_t[req.rid] = t0 - queue_wait
                self._pending.appendleft(req)
                blocked = True
                break
            dt = _now() - t0
            self.stats.prefill_s += dt
            self.stats.prefill_tokens += len(req.prompt)
            self.stats.admitted += 1
            self._last_prefill_s = max(self._last_prefill_s, dt)
            ttft = queue_wait + dt
            self.stats.queue_wait_s.append(queue_wait)
            self.stats.ttft_s.append(ttft)
            st = SlotState(request=req, tokens=[tok], next_token=tok,
                           admitted_step=self._step,
                           queue_wait_s=queue_wait, ttft_s=ttft)
            self._slots[slot] = st
            events.append((req.rid, tok))
            if self._done(st, tok):
                self._retire(slot)

        active = [i for i, s in enumerate(self._slots) if s is not None]
        if blocked and not active and not self._chunking:
            raise OutOfPages(
                f"page pool exhausted: request {self._pending[0].rid} "
                f"cannot be admitted and no active request remains to free "
                f"pages (pool: {self._geom.usable_pages} usable pages of "
                f"{self._geom.page_size} tokens)")
        self.stats.max_concurrent = max(self.stats.max_concurrent,
                                        len(active))
        if not active:
            return None

        toks = np.zeros((self.num_slots,), np.int32)
        done = np.ones((self.num_slots,), bool)
        budget = np.zeros((self.num_slots,), np.int32)
        for i in active:
            st = self._slots[i]
            toks[i] = st.next_token
            done[i] = False
            budget[i] = st.request.max_new_tokens - len(st.tokens)
        greedy_only = all(self._temp[i] == 0.0 for i in active)
        return active, toks, done, budget, greedy_only

    def _decoding(self) -> int:
        """The live decoding slots, which an admission or a chunk run
        now holds back from their next dispatch (0 with tracing off,
        where no span records it: no slot scan then)."""
        if not obs.enabled():
            return 0
        return sum(s is not None for s in self._slots)

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request] = (), *,
            step_timeout_s: float | None = None
            ) -> dict[int, GenerationResult]:
        """Drive until every submitted request has finished; a step whose
        admission prefill or decode block takes longer than
        ``step_timeout_s`` raises."""
        for r in requests:
            self.submit(r)
        while not self.idle:
            self.step()
            if step_timeout_s is not None and max(
                    self._last_prefill_s,
                    self._last_dispatch_s) > step_timeout_s:
                raise RuntimeError(
                    f"engine step {self._step} took longer than "
                    f"step_timeout_s={step_timeout_s}")
        return dict(self._results)

    def throughput(self) -> dict[str, float]:
        """Prefill and decode throughput, reported separately."""
        s = self.stats
        return {"prefill_tok_s": s.prefill_tok_s,
                "decode_tok_s": s.decode_tok_s,
                "prefill_s": s.prefill_s, "decode_s": s.decode_s}


# ----------------------------------------------------------------------
def lockstep_generate(model, params, ctx, prompts: Sequence[Sequence[int]],
                      max_new_tokens: int | Sequence[int], *, max_len: int,
                      frontend_embeds=None, device=None) -> list[list[int]]:
    """Greedy lock-step oracle: one ragged batch, one prefill, then
    synchronised decode.  The engine must match it token for token.
    ``frontend_embeds``: the batch's (B, P, d) vlm prefixes or encdec
    source frames.

    Decode is one program of static buffers, as JAX jits it with the
    cache donated: a ``(B, 1)`` token buffer and the prefill's cache.  A
    step runs ``Model.decode``, writes the greedy argmax into the token
    buffer and copies ``pos`` (and any other leaf ``decode`` returns
    anew) back into the cache.  On a CUDA device the first step runs
    eagerly, then one step is captured as a CUDA graph
    (:func:`repro_torch.graphs.capture`) and replayed for the rest; the
    graph and its pool live only for the call.  On the CPU every step
    runs the same body eagerly."""
    device = resolve_device(device)
    B = len(prompts)
    max_new = ([max_new_tokens] * B if isinstance(max_new_tokens, int)
               else [int(m) for m in max_new_tokens])
    lens = [len(p) for p in prompts]
    toks = torch.zeros((B, max(lens)), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :lens[i]] = torch.tensor(list(p), dtype=torch.long)
    batch = {"tokens": toks.to(device),
             "lengths": torch.tensor(lens, dtype=torch.int32, device=device)}
    if frontend_embeds is not None:
        batch["frontend_embeds"] = torch.as_tensor(frontend_embeds).to(
            device)
    logits, cache = model.prefill(params, batch, ctx, max_len)
    tok = sampling.greedy(logits[:, -1])[:, None].long()
    outs = [[int(t)] for t in tok[:, 0].cpu().tolist()]

    def step() -> torch.Tensor:
        logits, new = model.decode(params, cache, tok, ctx)
        tok.copy_(sampling.greedy(logits[:, -1])[:, None])
        for name, t in new.items():
            if t is not cache[name]:
                cache[name].copy_(t)
        return tok

    graph = None
    for i in range(max(max_new) - 1):
        if graph is not None:
            graphs.replay(graph)
        else:
            step()
            if device.type == "cuda" and i < max(max_new) - 2:
                graph = graphs.capture(step, device, "lockstep_decode", [])
        for b, t in enumerate(tok[:, 0].cpu().tolist()):
            if len(outs[b]) < max_new[b]:
                outs[b].append(int(t))
    return outs
