"""What a cell's output limit is set from, read on the chip in one process:
for each seed, every number of the output check, the program's on the
check's samples and the float8 control's on the same prompts and tokens.

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,... \
        --seconds 20 --out chiprun_out/readings.json

The engine is built and warmed up once; each seed redraws the weights
into the same buffers (so the captured graphs stay valid), offers the
cell's load for the ramp and ``--seconds`` at the cell's own rate or
clients, serves everything in flight to its end, and reads the sample as
a run of the benchmark does.  The benchmark's own runs do not run the
control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def read_seed(eng, spec, mix: dict, seed: int, seconds: float) -> dict:
    """One seed's readings on a built engine: the weights redrawn in
    place, the mix's load for the ramp and ``seconds``, everything in
    flight served to its end, then the check's sample read by the
    program's gaps and the control's."""
    from perfbench import check, e2e, harness, weights
    from perfbench.traffic import Traffic
    weights.redraw(eng.params, spec, seed)
    log = e2e.Log()
    t = time.perf_counter()
    load = harness.Load(Traffic(mix, seed, spec.vocab), eng, log, t)
    w0 = t + float(mix["ramp_seconds"])
    harness.serve(eng, load, log, w0 + seconds)
    nums = e2e.end_to_end(log, w0, w0 + seconds)
    harness.drain(eng, load, log)
    sample = check.pick(log, load, mix["check"], seed, since=w0)
    first = check.pick_first(log, load, mix["check"], seed, since=w0)
    r = check.readings(spec, seed, sample, eng.device, first)
    r.update(seed=seed, requests=len(sample),
             window={k: nums[k] for k in sorted(nums)})
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import os
    os.environ.setdefault("REPRO_TORCH_TUNE_CACHE",
                          str(ROOT / ".perfbench_cache" / "tune.json"))
    from perfbench import harness
    from perfbench.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    mix = cell.traffic
    spec, eng, _, _ = harness.build(cell.config, mix, seeds[0])
    rows = []
    for seed in seeds:
        r = read_seed(eng, spec, mix, seed, args.seconds)
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": cell.name, "rows": rows}
    for k in rows[0]["program"]:
        summary[f"program_{k}_max"] = max(r["program"][k] for r in rows)
        summary[f"control_{k}_min"] = min(r["control"][k] for r in rows)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
