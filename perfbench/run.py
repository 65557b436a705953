"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for.  The cells, their configurations, traffic mixes and metrics are
named in ``BENCHMARK.json``; ``perfbench/README.md`` says how they are
found.  The last line of standard output is the result, one JSON object;
the last lines of standard error are the numbers the output check
compared, each beside its limit.  Set-up (build, weights, engine,
captures, ramp) is timed and printed apart on standard error.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(code: int, msg: str) -> int:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / ".perfbench_cache"
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(cache / "tune.json")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    # the harness's own modules by package name, not from this folder
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(2, f"no program to measure: {ROOT / 'src/repro_torch'} "
                        "is missing")
    from perfbench.spec import load_cell
    cell = load_cell(args.workload, ROOT)

    import torch
    if not torch.cuda.is_available():
        return _fail(3, "no CUDA device: nothing measured")
    if torch.cuda.device_count() < cell.chips:
        return _fail(3, f"{cell.name} needs {cell.chips} CUDA devices, "
                        f"{torch.cuda.device_count()} found")

    from perfbench import harness
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_process=_T0)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(4, "loaded after the window: " + ", ".join(bad))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
