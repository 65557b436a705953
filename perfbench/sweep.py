"""The knee of an open-loop cell, found once on the chip: the cell's mix
offered at each of a few fixed rates, one engine for all of them.

    python3 perfbench/sweep.py --workload <cell> --rates 4,6,8,10 \
        --seconds 20 --out chiprun_out/sweep.json

For each rate: the ramp, then ``--seconds`` of window; TTFT p95 over the
window and over its two halves (a backlog that grows through the window
shows as a later half far slower than the earlier), TPOT p95, the
requests due in the window that got no first token, and the backlog left
when the window closed.  Everything in flight is served to its end
before the next rate.  The cell's traffic file takes about four fifths
of the highest rate the engine sustains.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import os
    os.environ.setdefault("REPRO_TORCH_TUNE_CACHE",
                          str(ROOT / ".perfbench_cache" / "tune.json"))
    from perfbench import e2e, harness
    from perfbench.spec import load_cell
    from perfbench.traffic import Traffic

    cell = load_cell(args.workload, ROOT)
    spec, eng, _, _ = harness.build(cell.config, cell.traffic, args.seed)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic, rate_per_s=rate)
        log = e2e.Log()
        t = time.perf_counter()
        load = harness.Load(Traffic(mix, args.seed, spec.vocab), eng, log, t)
        w0 = t + float(mix["ramp_seconds"])
        w1 = w0 + args.seconds
        harness.serve(eng, load, log, w1)
        backlog = eng.queue_depth
        load.submit_due(w1)
        harness.serve(eng, load, log, w1,
                      need=[r for r, d in log.due.items() if w0 <= d < w1])
        row = {"rate": rate, "backlog_at_close": backlog}
        for name, (a, b) in {"all": (w0, w1), "first": (w0, (w0 + w1) / 2),
                             "second": ((w0 + w1) / 2, w1)}.items():
            n = e2e.end_to_end(log, a, b)
            row[name] = {k: n.get(k) for k in ("ttft_p95_ms", "tpot_p95_ms",
                                                "attempted", "failed",
                                                "out_tok_s")}
        harness.drain(eng, load, log)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
