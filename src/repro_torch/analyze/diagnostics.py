"""Typed diagnostics: the machine-readable output of `repro_torch.analyze`.

The port's copy of ``repro.analyze.diagnostics``, unchanged.  Every
analyzer layer (schedule hazards, plan lint, program lint, kernel
launch lint) emits :class:`Diagnostic` records — rule id, severity,
location, message, fix hint — collected into a :class:`Report`.  Rule
ids are stable API (tests and CI gate on them) and are the JAX
package's; the catalog lives in ``analyze.RULES``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

__all__ = ["Diagnostic", "Report", "SEVERITIES"]

#: Ordered worst-first: ``Report.worst()`` returns the first present.
SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True, order=True)
class Diagnostic:
    """One static-analysis finding.

    ``rule`` is a stable id (``ZS-Sxxx`` schedule, ``ZS-Lxxx`` plan,
    ``ZS-Fxxx`` fault policy, ``ZS-Pxxx`` program); ``where`` names the
    subject (an OpKey string, a config repr, or a ``file:line`` source
    location); ``hint`` says how to fix it.
    """

    rule: str
    severity: str
    where: str
    message: str
    hint: str = ""
    #: occurrences collapsed into this record (see ``Report.dedupe``)
    count: int = 1

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"Diagnostic.severity must be one of "
                             f"{SEVERITIES}, got {self.severity!r}")
        if not isinstance(self.count, int) or self.count < 1:
            raise ValueError(f"Diagnostic.count must be a positive "
                             f"integer, got {self.count!r}")

    def format(self) -> str:
        line = f"{self.severity.upper():7s} {self.rule} [{self.where}] " \
               f"{self.message}"
        if self.count > 1:
            line += f"  (x{self.count})"
        if self.hint:
            line += f"  (fix: {self.hint})"
        return line

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Report:
    """An ordered collection of diagnostics with severity accounting."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = ()):
        self.diagnostics: list[Diagnostic] = list(diagnostics)
        #: free-form context set by drivers (arch, counters, ...)
        self.meta: dict = {}

    # ------------------------------------------------------------------
    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    # ------------------------------------------------------------------
    def by_severity(self, severity: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> list[Diagnostic]:
        return self.by_severity("error")

    @property
    def warnings(self) -> list[Diagnostic]:
        return self.by_severity("warning")

    def rules(self) -> set[str]:
        return {d.rule for d in self.diagnostics}

    def rule_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for d in self.diagnostics:
            counts[d.rule] = counts.get(d.rule, 0) + d.count
        return dict(sorted(counts.items()))

    def dedupe(self) -> "Report":
        """Collapse identical ``(rule, where, message)`` findings.

        Configuration sweeps (a tuning space × kernel families) repeat
        the same finding per swept config; a deduped report emits each
        once with an occurrence ``count`` so real findings are not
        drowned.  Order of first occurrence is preserved; the worst
        severity and the first non-empty hint win.  ``meta`` is carried
        over and gains ``dedup`` (collapsed occurrence counts per
        ``rule@where``) so the totals survive serialization.
        """
        merged: dict[tuple, Diagnostic] = {}
        for d in self.diagnostics:
            key = (d.rule, d.where, d.message)
            prev = merged.get(key)
            if prev is None:
                merged[key] = d
                continue
            sev = min(prev.severity, d.severity,
                      key=SEVERITIES.index)
            merged[key] = dataclasses.replace(
                prev, severity=sev, hint=prev.hint or d.hint,
                count=prev.count + d.count)
        out = Report(merged.values())
        out.meta = dict(self.meta)
        dup = {f"{d.rule}@{d.where}": d.count
               for d in merged.values() if d.count > 1}
        if dup:
            out.meta["dedup"] = dup
        return out

    def worst(self) -> str | None:
        """The most severe level present (None when clean)."""
        for sev in SEVERITIES:
            if self.by_severity(sev):
                return sev
        return None

    def ok(self, fail_on: str = "error") -> bool:
        """True when no diagnostic at or above ``fail_on`` severity.

        ``fail_on="warning"`` fails on warnings AND errors (the CI
        gate); ``"error"`` fails on errors only (the load-time gate).
        """
        if fail_on not in ("error", "warning"):
            raise ValueError(f"fail_on must be 'error' or 'warning', "
                             f"got {fail_on!r}")
        bad = SEVERITIES[:SEVERITIES.index(fail_on) + 1]
        return not any(d.severity in bad for d in self.diagnostics)

    # ------------------------------------------------------------------
    def format(self) -> str:
        if not self.diagnostics:
            return "clean (no diagnostics)"
        return "\n".join(d.format() for d in self.diagnostics)

    def to_json(self) -> dict:
        out = {"diagnostics": [d.to_json() for d in self.diagnostics],
               "rule_counts": self.rule_counts(),
               "worst": self.worst()}
        if self.meta:
            out["meta"] = dict(self.meta)
        return out

    def __repr__(self) -> str:
        n = {s: len(self.by_severity(s)) for s in SEVERITIES}
        return (f"Report(errors={n['error']}, warnings={n['warning']}, "
                f"info={n['info']})")
