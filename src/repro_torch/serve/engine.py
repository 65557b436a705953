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

The K-step block is a Python loop of ``Model.decode`` calls here; CUDA
graphs come later.  Greedy decode through the engine is token-for-token
identical to :func:`lockstep_generate`.  Paged KV, chunked prefill,
execution plans and plan validation are not ported yet (ROADMAP.md,
queue 1 item 7 and later slices).
"""

from __future__ import annotations

import collections
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serve import sampling
from repro_torch.serve.request import GenerationResult, Request, SlotState
from repro_torch.serve.stats import EngineStats

__all__ = ["ServeEngine", "lockstep_generate"]

_SLICE_2 = ("is not ported yet: paged serving, chunked prefill, plans and "
            "plan validation come in slice 2 of the port (ROADMAP.md queue 1 "
            "item 7)")


def _host(x: torch.Tensor) -> np.ndarray:
    """THE device->host boundary.  Every readback the engine performs
    funnels through here, so tests can count the syncs per dispatch."""
    return x.cpu().numpy()


# THE engine clock: every latency the engine records reads it, so tests
# can substitute a fake clock.
_now = time.perf_counter


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
    """

    def __init__(self, model, params, ctx, *, num_slots: int = 4,
                 max_len: int = 128, cache_dtype: torch.dtype = torch.float32,
                 steps_per_dispatch: int = 1,
                 bucket_sizes: Sequence[int] | None = None,
                 eos_id: int | None = None, seed: int = 0, device=None,
                 page_size: int | None = None,
                 prefill_chunk: int | None = None, plan=None,
                 validate: bool = False):
        for name, val in (("page_size", page_size),
                          ("prefill_chunk", prefill_chunk), ("plan", plan)):
            if val is not None:
                raise NotImplementedError(f"ServeEngine({name}=...) {_SLICE_2}")
        if validate:
            raise NotImplementedError(f"ServeEngine(validate=True) {_SLICE_2}")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.ctx = ctx
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        self.eos_id = eos_id
        self.seed = int(seed)
        if bucket_sizes is None:
            bucket_sizes, b = [], 8
            while b < max_len:
                bucket_sizes.append(b)
                b *= 2
            bucket_sizes.append(max_len)
        self.bucket_sizes = tuple(sorted(set(int(b) for b in bucket_sizes)))

        self.cache = model.init_cache(self.num_slots, self.max_len,
                                      cache_dtype, device=self.device)
        self.cache["pos"] = torch.zeros((self.num_slots,), dtype=torch.int32,
                                        device=self.device)
        # per-slot sampling state: a generator per slot (set at
        # admission) and host mirrors of the knobs
        self._gens: list[torch.Generator | None] = [None] * self.num_slots
        self._temp = np.zeros((self.num_slots,), np.float32)
        self._topk = np.zeros((self.num_slots,), np.int32)
        self._topp = np.ones((self.num_slots,), np.float32)

        self._pending: collections.deque[Request] = collections.deque()
        self._slots: list[SlotState | None] = [None] * self.num_slots
        self._results: dict[int, GenerationResult] = {}
        self._step = 0
        self.stats = EngineStats(num_slots=self.num_slots)
        self._submit_t: dict[int, float] = {}
        self._last_prefill_s = 0.0
        self._last_dispatch_s = 0.0

    # ------------------------------------------------------------------
    def _decode_block(self, tok: torch.Tensor, done: torch.Tensor,
                      budget: torch.Tensor, *, greedy_only: bool
                      ) -> torch.Tensor:
        """K decode+sample iterations over all slots -> (num_slots, K)
        tokens, with no host sync.  Frozen (done) rows re-feed their last
        token and stop consuming budget; their cache rows still see
        writes, which land in their own stripe (clamped in bounds) and
        are overwritten at the slot's next admission.  ``greedy_only``
        is the argmax specialisation of an all-greedy slot pool: no
        sort and no draw."""
        model, ctx, eos = self.model, self.ctx, self.eos_id
        if not greedy_only:
            temp = torch.from_numpy(self._temp).to(self.device)
            topk = torch.from_numpy(self._topk).to(self.device)
            topp = torch.from_numpy(self._topp).to(self.device)
            gens = [g if t > 0 else None
                    for g, t in zip(self._gens, self._temp)]
        out = []
        for _ in range(self.steps_per_dispatch):
            logits, self.cache = model.decode(self.params, self.cache,
                                              tok[:, None], ctx)
            if greedy_only:
                nxt = sampling.greedy(logits[:, -1])
            else:
                nxt = sampling.sample(logits[:, -1], gens, temp, topk, topp)
            nxt = torch.where(done, tok, nxt)
            budget = budget - (~done).to(torch.int32)
            newly = budget <= 0
            if eos is not None:
                newly = newly | (nxt == eos)
            done = done | newly
            tok = nxt
            out.append(nxt)
        return torch.stack(out, dim=1)

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        budget = len(request.prompt) + request.max_new_tokens
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
        return not self._pending and all(s is None for s in self._slots)

    def _bucket(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return min(b, self.max_len)
        raise ValueError(f"prompt length {n} exceeds the largest bucket "
                         f"{self.bucket_sizes[-1]}")

    def _admit(self, req: Request, slot: int) -> int:
        """Batch-1 prefill into ``slot``; returns the first token."""
        n = len(req.prompt)
        toks = torch.zeros((1, self._bucket(n)), dtype=torch.long)
        toks[0, :n] = torch.tensor(req.prompt, dtype=torch.long)
        batch = {"tokens": toks.to(self.device),
                 "lengths": torch.tensor([n], dtype=torch.int32,
                                         device=self.device)}
        logits, cache1 = self.model.prefill(self.params, batch, self.ctx,
                                            self.max_len)
        self.cache["k"][:, slot] = cache1["k"][:, 0].to(self.cache["k"].dtype)
        self.cache["v"][:, slot] = cache1["v"][:, 0].to(self.cache["v"].dtype)
        self.cache["pos"][slot] = cache1["pos"][0]
        return self._first_token(req, slot, logits)

    def _first_token(self, req: Request, slot: int, logits) -> int:
        """Sample the first token with the request's own knobs and a
        fresh generator for the slot (one sync per admission)."""
        seed = req.seed if req.seed is not None else \
            sampling.request_seed(self.seed, req.rid)
        g = sampling.make_generator(seed, self.device)
        self._gens[slot] = g
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        if req.temperature > 0:
            dev = self.device
            tok = sampling.sample(
                logits[:, -1], [g],
                torch.full((1,), req.temperature, device=dev),
                torch.full((1,), req.top_k, dtype=torch.int32, device=dev),
                torch.full((1,), req.top_p, device=dev))
        else:
            tok = sampling.greedy(logits[:, -1])
        return int(_host(tok)[0])

    def _retire(self, slot: int) -> None:
        st = self._slots[slot]
        self._results[st.request.rid] = GenerationResult(
            rid=st.request.rid, prompt_len=len(st.request.prompt),
            tokens=st.tokens, admitted_step=st.admitted_step,
            finished_step=self._step, queue_wait_s=st.queue_wait_s,
            ttft_s=st.ttft_s)
        self._slots[slot] = None
        self._gens[slot] = None
        self.stats.retired += 1

    def _done(self, st: SlotState, tok: int) -> bool:
        return (len(st.tokens) >= st.request.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id))

    # ------------------------------------------------------------------
    def step(self) -> list[tuple[int, int]]:
        """Admissions + one decode block (K iterations, one host sync).
        Returns streamed (rid, token) events in emission order."""
        events: list[tuple[int, int]] = []
        self._step += 1
        self._last_prefill_s = 0.0
        self._last_dispatch_s = 0.0

        for slot in range(self.num_slots):
            if self._slots[slot] is not None or not self._pending:
                continue
            req = self._pending.popleft()
            t0 = _now()
            queue_wait = t0 - self._submit_t.pop(req.rid, t0)
            tok = self._admit(req, slot)
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
        self.stats.max_concurrent = max(self.stats.max_concurrent,
                                        len(active))
        if not active:
            return events

        K = self.steps_per_dispatch
        toks = np.zeros((self.num_slots,), np.int64)
        done = np.ones((self.num_slots,), bool)
        budget = np.zeros((self.num_slots,), np.int32)
        for i in active:
            st = self._slots[i]
            toks[i] = st.next_token
            done[i] = False
            budget[i] = st.request.max_new_tokens - len(st.tokens)
        greedy_only = all(self._temp[i] == 0.0 for i in active)
        t0 = _now()
        block = self._decode_block(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(done).to(self.device),
            torch.from_numpy(budget).to(self.device),
            greedy_only=greedy_only)
        block = _host(block)          # THE one sync of this dispatch
        dt = _now() - t0
        self._last_dispatch_s = dt
        self.stats.decode_s += dt
        self.stats.decode_steps += K
        self.stats.dispatches += 1
        self.stats.dispatch_occupancy.append(len(active) / self.num_slots)
        per_token_s = dt / K

        # drain step-major so events are ordered like K single steps
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
        return events

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
                      device=None) -> list[list[int]]:
    """Greedy lock-step oracle: one ragged batch, one prefill, then
    synchronised decode.  The engine must match it token for token."""
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
    logits, cache = model.prefill(params, batch, ctx, max_len)
    tok = sampling.greedy(logits[:, -1])
    outs = [[int(t)] for t in tok.cpu().tolist()]
    for _ in range(max(max_new) - 1):
        logits, cache = model.decode(params, cache, tok[:, None].long(), ctx)
        tok = sampling.greedy(logits[:, -1])
        for i, t in enumerate(tok.cpu().tolist()):
            if len(outs[i]) < max_new[i]:
                outs[i].append(int(t))
    return outs
