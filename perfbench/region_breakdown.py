"""Where a cell's decode device time goes, by region of the program.

    python3 perfbench/region_breakdown.py --workload <cell> --seed <n> \\
        --seconds <s>

from the root of a checkout, on a machine with the chips the cell asks
for.  It runs the cell as ``perfbench/run.py --trace 1`` does (the same
result line on standard output) and then prints on standard error, one
line a region, the device time of the traced decode dispatches whose
events matched their graph's map (:mod:`perfbench.regions`): ms a decode
step (the matched dispatches' device time in the region over their
steps), its share of their device time, and the kernels with the most
time in it.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

__all__ = ["breakdown", "lines", "main"]


def breakdown(run, top: int = 3) -> dict:
    """The matched dispatches of ``run`` by region: ``dispatches`` and
    ``matched`` (traced dispatch spans, and those whose events matched),
    ``steps`` (the matched ones' decode steps), ``device_ms_per_step``,
    and ``regions``, each ``{"region", "ms_per_step", "share_pct",
    "top": [[kernel, ms a step], ...]}``, the most time first."""
    from perfbench import regions
    got = regions.dispatches(run)
    secs = collections.Counter()
    kernels = collections.defaultdict(collections.Counter)
    steps = 0
    for s, evs in got:
        if evs is None:
            continue
        steps += s["k"]
        for name, a, b, region in evs:
            secs[region] += b - a
            kernels[region][name] += b - a
    total = sum(secs.values())
    out = {"dispatches": len(got),
           "matched": sum(evs is not None for _, evs in got),
           "steps": steps,
           "device_ms_per_step": 1e3 * total / steps if steps else None,
           "regions": []}
    for region, t in secs.most_common():
        out["regions"].append({
            "region": region, "ms_per_step": 1e3 * t / steps,
            "share_pct": 100.0 * t / total if total else 0.0,
            "top": [[k, 1e3 * v / steps]
                    for k, v in kernels[region].most_common(top)]})
    return out


def lines(bd: dict) -> list[str]:
    """``bd`` (:func:`breakdown`) as printed lines."""
    out = [f"dispatches {bd['dispatches']}, matched {bd['matched']}, "
           f"steps {bd['steps']}"]
    if bd["device_ms_per_step"] is None:
        return out + ["no dispatch matched its graph's map: nothing to "
                      "break down"]
    out.append(f"device ms a step {bd['device_ms_per_step']:.4f}")
    for r in bd["regions"]:
        top = "; ".join(f"{k[:80]} {ms:.4f}" for k, ms in r["top"])
        out.append(f"  {r['region']}: {r['ms_per_step']:.4f} ms a step, "
                   f"{r['share_pct']:.2f}%; top: {top}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", required=True)
    args = ap.parse_args(argv)
    # the harness's own modules by package name, not from this folder
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    from perfbench import run, spec

    # the harness hands the run to each per-layer reader (it binds
    # spec.metric_reader when it is imported, inside run.main): keep it
    runs = []
    reader_of = spec.metric_reader

    def metric_reader(name, *a, **kw):
        read = reader_of(name, *a, **kw)

        def keep(r):
            if not runs:
                runs.append(r)
            return read(r)
        return keep

    spec.metric_reader = metric_reader
    rc = run.main(["--workload", args.workload, "--seed", args.seed,
                   "--seconds", args.seconds, "--trace", "1"])
    if rc != 0 or not runs:
        return rc or 1
    bd = breakdown(runs[0])
    for ln in lines(bd):
        print(f"[regions] {ln}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
