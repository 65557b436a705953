"""Request/response types for the continuous-batching serving engine."""

from __future__ import annotations

import dataclasses

__all__ = ["Request", "GenerationResult", "SlotState"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.

    ``prompt``: token ids (any int sequence).  ``max_new_tokens``
    includes the token sampled from the prefill logits.  Sampling knobs
    (see :mod:`repro_torch.serve.sampling`): ``temperature`` (0 = exact
    greedy argmax, the default), ``top_k`` (0 disables), ``top_p`` (1.0
    disables), and ``seed`` for the request's private generator
    (``None`` derives one from the engine seed and the rid).  A
    request's samples depend only on its seed and token position, never
    on batch composition or the engine's block size.
    """
    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(int(t) for t in self.prompt))
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError(f"request {self.rid}: temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"request {self.rid}: top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"request {self.rid}: top_p must be in (0, 1]")


@dataclasses.dataclass
class GenerationResult:
    """Completed request: generated ids plus per-request accounting.

    ``queue_wait_s``: submit -> admission start.  ``ttft_s``: submit ->
    first token on the host.  Both read the engine clock
    (``repro_torch.serve.engine._now``).
    """
    rid: int
    prompt_len: int
    tokens: list[int]
    admitted_step: int
    finished_step: int
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0


@dataclasses.dataclass
class SlotState:
    """Book-keeping for one occupied decode slot."""
    request: Request
    tokens: list[int]
    next_token: int
    admitted_step: int
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
