"""The end-to-end metrics, from the harness's own event log.

The log holds, for every request, the time it fell due and the host time
at which each of its tokens reached the harness (the return of the
engine step that emitted it), and for every engine step the tokens it
returned.  Nothing here reads the engine's own clocks or statistics:

* ``out_tok_s``: every token that reached the harness inside the window,
  first tokens included, over the window's seconds;
* ``tpot_p95_ms``: for every request whose last token came inside the
  window, (time of its last token - time of its first) / (tokens - 1),
  the 95th percentile over all of them;
* ``ttft_p95_ms``: for every request due inside the window, the time
  from when it was due (not submitted) to its first token, the 95th
  percentile over all of them.  The harness keeps serving past the
  window until each has its first token, so a late one counts with its
  whole wait; one that never gets it is counted failed.
"""

from __future__ import annotations

import dataclasses

from perfbench.spec import percentile

__all__ = ["Log", "end_to_end"]


@dataclasses.dataclass
class Log:
    due: dict = dataclasses.field(default_factory=dict)
    first: dict = dataclasses.field(default_factory=dict)
    done: dict = dataclasses.field(default_factory=dict)
    tokens: dict = dataclasses.field(default_factory=dict)
    times: dict = dataclasses.field(default_factory=dict)
    # (step start, step return, tokens returned) of every engine step
    steps: list = dataclasses.field(default_factory=list)

    def emit(self, rid: int, tok: int, t: float) -> None:
        self.first.setdefault(rid, t)
        self.tokens.setdefault(rid, []).append(int(tok))
        self.times.setdefault(rid, []).append(t)


def _in(t: float, w0: float, w1: float) -> bool:
    return w0 <= t < w1


def end_to_end(log: Log, w0: float, w1: float) -> dict:
    """Every end-to-end number of the window [w0, w1), with the sample
    counts behind it."""
    out = {}
    n_tok = sum(n for _, t, n in log.steps if _in(t, w0, w1))
    out["out_tok_s"] = n_tok / (w1 - w0)
    out["tokens"] = n_tok
    tpot = [(log.done[r] - log.first[r]) / (len(log.tokens[r]) - 1)
            for r in log.done
            if _in(log.done[r], w0, w1) and len(log.tokens[r]) > 1]
    out["tpot_n"] = len(tpot)
    if tpot:
        out["tpot_p95_ms"] = 1e3 * percentile(tpot, 95)
    due = [r for r, t in log.due.items() if _in(t, w0, w1)]
    ttft = [log.first[r] - log.due[r] for r in due if r in log.first]
    out["attempted"] = len(due)
    out["failed"] = len(due) - len(ttft)
    out["ttft_n"] = len(ttft)
    if ttft:
        out["ttft_p95_ms"] = 1e3 * percentile(ttft, 95)
    return out
