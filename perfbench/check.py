"""The output check that decides ``correct``.

Once the window has closed, a sample drawn from the seed of the greedy
requests that finished in it (the longest among them, then others until
the sample holds ``min_tokens`` served tokens or ``max_requests``
requests) is read back against the plain reference
(:mod:`perfbench.reference.model`): one float32 pass over each prompt
with its served tokens.  The numbers compared are the gaps by which
the served tokens' reference logits lie below the reference's best logit at
their positions (a greedy token of a sound bfloat16 program lies within
rounding of the best): the widest, ``max_logit_gap``, and the mean,
``mean_logit_gap``.  The first token comes from the prefill program and
the rest from the decode program.  So that the prefill program is judged
on its own and cannot be averaged away among thousands of decode tokens,
a second seeded sample (:func:`pick_first`) takes the first token of up
to ``first_tokens`` greedy requests whose first token came in the window,
finished or not, and reads ``first_token_mean_gap`` and
``first_token_max_gap`` over them; ``request_mean_gap`` is the largest of
the sample's per-request mean gaps, so that one bad request cannot be
averaged away either.  Each number is compared where the configuration's
``check`` gives it a limit.  Each served request must also have all the
tokens it asked for.

:func:`readings` gives what the limits are set from: each number of the
program and of the control, the reference computed in float8 put in the
program's place (at each position the token float8 puts first, read
against the float32 reference).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as reference
from perfbench.spec import ModelSpec

__all__ = ["pick", "pick_first", "judge", "gaps", "numbers", "readings"]


def pick(log, load, rule: dict, seed: int, since: float) -> list[dict]:
    """The seeded sample of greedy requests finished at or after
    ``since``: each with its prompt, served tokens and asked length."""
    done = sorted(r for r, t in log.done.items()
                  if t >= since and load.requests[r].temperature == 0.0)
    if not done:
        return []
    rng = np.random.default_rng([seed, 3])
    longest = max(done, key=lambda r: (len(log.tokens[r]), -r))
    rest = [r for r in done if r != longest]
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for rid in order:
        if n >= rule["min_tokens"] or len(out) >= rule["max_requests"]:
            break
        req = load.requests[rid]
        out.append({"rid": rid, "prompt": list(req.prompt),
                    "tokens": list(log.tokens[rid]),
                    "asked": req.max_new_tokens})
        n += len(log.tokens[rid])
    return out


def pick_first(log, load, rule: dict, seed: int, since: float) -> list[dict]:
    """The seeded sample of up to ``first_tokens`` greedy requests whose
    first token reached the harness at or after ``since``: each with its
    prompt and that one token."""
    due = sorted(r for r, t in log.first.items()
                 if t >= since and load.requests[r].temperature == 0.0)
    rng = np.random.default_rng([seed, 4])
    take = [due[i] for i in rng.permutation(len(due))][
        :int(rule.get("first_tokens", 0))]
    return [{"rid": r, "prompt": list(load.requests[r].prompt),
             "tokens": log.tokens[r][:1], "asked": 1} for r in take]


def _batches(sample: list[dict]):
    seqs = [torch.tensor([s["prompt"] + s["tokens"][:-1]]) for s in sample]
    return seqs, [len(s["prompt"]) - 1 for s in sample]


def _reference(spec, seed, sample, first, device, precision="fp32"):
    """The reference's logits over the sample and the first-token sample,
    in one pass (each layer drawn once)."""
    seqs, start = _batches(sample + first)
    out = reference.forward(spec, seed, seqs, device, start=start,
                            precision=precision)
    return out[:len(sample)], out[len(sample):]


def gaps(ref_logits: list, sample: list[dict], choice=None) -> list:
    """Per request, the gap of each served token (or of the token
    ``choice`` puts first: the control's) below the reference's best."""
    out = []
    for lg, s, ch in zip(ref_logits, sample,
                         choice or [None] * len(sample)):
        lg = lg[0]
        tok = (torch.tensor(s["tokens"], device=lg.device) if ch is None
               else ch[0].argmax(-1))
        out.append((lg.max(-1).values
                    - lg.gather(1, tok[:, None])[:, 0]).cpu())
    return out


def numbers(g: list, g_first: list) -> dict:
    """Every number the check can compare, from the per-request gaps of
    the sample and of the first-token sample."""
    out = {}
    if g:
        cat = torch.cat(g)
        out.update(max_logit_gap=float(cat.max()),
                   mean_logit_gap=float(cat.mean()),
                   request_mean_gap=max(float(x.mean()) for x in g))
    if g_first:
        cat = torch.cat(g_first)
        out.update(first_token_max_gap=float(cat.max()),
                   first_token_mean_gap=float(cat.mean()))
    return out


def judge(spec: ModelSpec, seed: int, sample: list[dict], rule: dict,
          device, first: list[dict] = ()) -> dict:
    """``correct`` and the numbers compared, each beside its limit: the
    samples' sizes, their completeness and token ids, and each gap number
    the configuration's ``check`` gives a limit."""
    # the first-token sample is read only where a number of it is compared
    first = list(first) if any(n.startswith("first_token") for n in rule) \
        else []
    both = sample + first
    bad_ids = sum(1 for s in both for t in s["tokens"]
                  if not 0 <= t < spec.vocab)
    incomplete = sum(1 for s in sample if len(s["tokens"]) != s["asked"])
    checks = {
        "sampled_requests": {"value": len(sample), "limit": 1},
        "served_tokens": {"value": sum(len(s["tokens"]) for s in sample),
                          "limit": 1},
        "incomplete": {"value": incomplete, "limit": 0},
        "bad_token_ids": {"value": bad_ids, "limit": 0},
    }
    correct = len(sample) >= 1 and incomplete == 0 and bad_ids == 0
    if any(name.startswith("first_token") for name in rule):
        checks["first_tokens"] = {"value": len(first), "limit": 1}
        correct = correct and len(first) >= 1
    nums = {}
    if sample and not bad_ids:
        ref, ref_first = _reference(spec, seed, sample, first, device)
        nums = numbers(gaps(ref, sample), gaps(ref_first, first))
    for name in ("max_logit_gap", "mean_logit_gap", "request_mean_gap",
                 "first_token_max_gap", "first_token_mean_gap"):
        if name in rule:
            value = nums.get(name)
            checks[name] = {"value": value, "limit": float(rule[name])}
            correct = correct and value is not None \
                and value <= float(rule[name])
    return {"correct": bool(correct), "checks": checks}


def _stats(g: list, g_first: list) -> dict:
    out = numbers(g, g_first)
    cat = torch.cat(g)
    out.update(p99=float(torch.quantile(cat, 0.99)),
               off_best=float((cat > 0).float().mean()))
    return out


def readings(spec: ModelSpec, seed: int, sample: list[dict], device,
             first: list[dict] = ()) -> dict:
    """Every number of the program and of the float8 control, over the
    same prompts and tokens, with the 99th percentile of the gaps and the
    share of tokens that are not the reference's best."""
    first = list(first)
    ref, ref_first = _reference(spec, seed, sample, first, device)
    program = _stats(gaps(ref, sample), gaps(ref_first, first))
    ctl, ctl_first = _reference(spec, seed, sample, first, device, "fp8")
    control = _stats(gaps(ref, sample, ctl), gaps(ref_first, first, ctl_first))
    return {"program": program, "control": control,
            "tokens": sum(len(s["tokens"]) for s in sample),
            "first_tokens": len(first)}
