"""Static zero-stall verification of the port over the model-family configs.

Runs the ``repro_torch.analyze`` layers — plan lint + revolving-buffer
hazard simulation, and program lint over the prefill / decode / loss /
fused K-step dispatch programs — for one architecture per model family
(dense, moe, ssm, hybrid, encdec), each plan-traced on the meta device
(shapes only: no card needed, no FLOPs).  Full-family sweeps also audit
the program-lint allowlist for stale entries (ZS-P004).

``--kernels`` runs the kernel launch verifier instead: every kernel
family is swept across the port's Hopper tuning space and each launch
geometry is proven to realize the revolving-buffer schedule
(ZS-K001..K005).

Usage:
  PYTHONPATH=src python -m repro_torch.analyze --all-families
  PYTHONPATH=src python -m repro_torch.analyze --arch gemma-7b --json
  PYTHONPATH=src python -m repro_torch.analyze --all-families --quant int8
  PYTHONPATH=src python -m repro_torch.analyze --kernels --fail-on warning
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture or family name (repeatable); "
                         "families: dense moe ssm hybrid encdec")
    ap.add_argument("--all-families", action="store_true",
                    help="analyze one representative arch per family")
    ap.add_argument("--backend", default="auto", choices=["auto", "torch"],
                    help="backend the traced plan resolves for (default: "
                         "auto, the Hopper kernels' configs)")
    ap.add_argument("--quant", default=None, choices=["int8"],
                    help="also exercise the quantized path")
    ap.add_argument("--fused-steps", type=int, default=4,
                    help="K of the fused decode+sample block to lint "
                         "(<=1 skips the fused-block lint)")
    ap.add_argument("--kernels", action="store_true",
                    help="run the kernel launch verifier: sweep every "
                         "kernel family across the Hopper tuning space")
    ap.add_argument("--kernel-family", action="append", default=None,
                    choices=["zero_stall", "grouped", "quantized",
                             "attention"],
                    help="restrict --kernels to one family (repeatable)")
    ap.add_argument("--fail-on", default="error",
                    choices=["error", "warning"],
                    help="exit nonzero when any diagnostic at or above "
                         "this severity is found")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object (reports keyed by arch)")
    args = ap.parse_args(argv)

    if args.kernels:
        return _run_kernels(args)

    from repro_torch.analyze import FAMILY_ARCHS, analyze_families
    from repro_torch.configs import get_config

    if args.all_families or not args.arch:
        families = list(FAMILY_ARCHS)
    else:
        families = args.arch
        for name in families:
            try:
                get_config(FAMILY_ARCHS.get(name, name), reduced=True)
            except (KeyError, ValueError) as e:
                print(f"analyze: unknown arch {name!r}: {e}",
                      file=sys.stderr)
                return 2
    reports = analyze_families(families, backend=args.backend,
                               quant=args.quant,
                               fused_steps=args.fused_steps)
    ok = all(rep.ok(args.fail_on) for rep in reports.values())
    if args.json:
        print(json.dumps({arch: rep.to_json()
                          for arch, rep in reports.items()}, indent=2))
    else:
        for arch, rep in reports.items():
            meta = rep.meta
            print(f"{arch} [{meta.get('family', '?')}]: "
                  f"{meta.get('plan_entries', 0)} plan entries, "
                  f"{meta.get('programs_linted', 0)} programs -> {rep!r}")
            if len(rep):
                print(rep.format())
        verdict = "PASS" if ok else f"FAIL (fail-on={args.fail_on})"
        print(f"analyze: {len(reports)} config(s) checked -> {verdict}")
    return 0 if ok else 1


def _run_kernels(args) -> int:
    from repro_torch.analyze import lint_kernels

    report = lint_kernels(args.kernel_family)
    ok = report.ok(args.fail_on)
    if args.json:
        print(json.dumps({"kernels": report.to_json()}, indent=2))
    else:
        meta = report.meta
        print(f"kernel launches: {meta.get('kernels_verified', 0)} verified "
              f"across {meta.get('families', {})} -> {report!r}")
        if len(report):
            print(report.format())
        verdict = "PASS" if ok else f"FAIL (fail-on={args.fail_on})"
        print(f"analyze --kernels: {verdict}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
