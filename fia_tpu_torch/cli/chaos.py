"""The chaos engine's command line: seeded schedules, smoke/soak sweeps,
replay (port of ``fia_tpu/cli/chaos.py``: the same flags, plus
``--backend``).

Modes (mutually exclusive, checked in this order):

- ``--smoke``: the fixed-seed gate. Benign schedules
  (bit-identity-preserving fault kinds only) across the selftest and
  the end-to-end scenarios; every run must reproduce its golden run
  bit-identically and satisfy the full oracle battery. Deterministic.
- ``--soak LO:HI``: a seed-range sweep over the full fault domain
  (with ``--all_kinds``) with ``--faults`` faults per schedule — the
  long-running fuzz mode.
- ``--replay repro.json``: re-run a shrunk repro schedule emitted by a
  failing run. Exits nonzero iff the failure reproduces — the repro
  file is a failing test you can hand to whoever owns the bug.
- default: one schedule for ``--scenario``/``--seed``/``--faults``
  (``--all_kinds`` switches from the benign to the full domain), with
  automatic ddmin shrinking + repro emission on oracle failure.

``--backend``: none (the default) runs every scenario on the CUDA device
and raises without one; ``cpu`` runs them on the CPU.

Run:  python -m fia_tpu_torch.cli.chaos --smoke
      python -m fia_tpu_torch.cli.chaos --smoke --backend cpu
      python -m fia_tpu_torch.cli.chaos --scenario train_resume --seed 7 --faults 3
      python -m fia_tpu_torch.cli.chaos --replay /tmp/chaos/repro-*.json
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from fia_tpu_torch.chaos.runner import ChaosEngine
from fia_tpu_torch.chaos.scenarios import SCENARIO_NAMES

# The smoke battery: the device-free selftest plus the end-to-end
# scenarios, two benign seeded schedules each. The mesh scenarios lay
# their slots over the real devices, or over virtual slots on one.
SMOKE_SCENARIOS = ("selftest", "train_resume", "query_cache",
                   "serve_stream", "serve_stream_mesh",
                   "device_loss_recovery", "host_loss_recovery",
                   "factor_bank",
                   "update_while_serving", "unlearn_while_serving",
                   "serve_brownout", "serve_multitenant")
SMOKE_SEEDS_PER_SCENARIO = 2
SMOKE_FAULTS = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fia_tpu_torch.cli.chaos",
        description="seeded fault schedules against end-to-end scenarios",
    )
    p.add_argument("--smoke", action="store_true",
                   help="fixed-seed benign battery (the tier-1 gate)")
    p.add_argument("--soak", type=str, default=None, metavar="LO:HI",
                   help="seed-range sweep over the full fault domain")
    p.add_argument("--replay", type=str, default=None, metavar="REPRO",
                   help="re-run a repro JSON; nonzero exit iff it "
                        "still fails")
    p.add_argument("--scenario", action="append",
                   choices=list(SCENARIO_NAMES), default=None,
                   help="scenario(s) to run (repeatable; default: the "
                        "smoke set)")
    p.add_argument("--seed", type=int, default=0,
                   help="schedule seed (soak: offset added to the range)")
    p.add_argument("--faults", type=int, default=SMOKE_FAULTS,
                   help="faults per generated schedule")
    p.add_argument("--all_kinds", action="store_true",
                   help="draw from the full fault domain (kill kinds, "
                        "solver escalation) instead of the benign one; "
                        "bit-identity is then checked only on served "
                        "answers, not whole outcomes")
    p.add_argument("--no_shrink", action="store_true",
                   help="skip ddmin shrinking on failure")
    p.add_argument("--workdir", type=str, default=None,
                   help="root for run dirs + repro files (default: a "
                        "fresh temp dir)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-run progress lines")
    p.add_argument("--backend", type=str, default=None,
                   choices=[None, "cuda", "cpu"],
                   help="torch device (default: the CUDA device, raising "
                        "without one; 'cpu' runs on the CPU)")
    return p


def _engine(args) -> ChaosEngine:
    root = args.workdir or tempfile.mkdtemp(prefix="fia-chaos-")
    return ChaosEngine(root, verbose=not args.quiet, device=args.backend)


def _finish(reports, eng: ChaosEngine, label: str) -> int:
    failed = [r for r in reports if not r.passed]
    summary = {
        "mode": label,
        "runs": len(reports),
        "passed": len(reports) - len(failed),
        "failed": [r.to_dict() for r in failed],
        "workdir": eng.root,
    }
    print(json.dumps(summary, indent=2, default=str))
    if failed:
        for r in failed:
            if r.repro_path:
                print(f"[chaos] repro: python -m fia_tpu_torch.cli.chaos "
                      f"--replay {r.repro_path}", file=sys.stderr)
        return 1
    return 0


def run_smoke(args) -> int:
    eng = _engine(args)
    names = args.scenario or list(SMOKE_SCENARIOS)
    reports = []
    for name in names:
        for i in range(SMOKE_SEEDS_PER_SCENARIO):
            reports.append(eng.run(
                name, seed=args.seed + i, n_faults=args.faults,
                benign=True, shrink=not args.no_shrink))
    return _finish(reports, eng, "smoke")


def run_soak(args) -> int:
    try:
        lo, hi = (int(v) for v in args.soak.split(":"))
    except ValueError:
        print(f"--soak wants LO:HI, got {args.soak!r}", file=sys.stderr)
        return 2
    eng = _engine(args)
    names = args.scenario or list(SMOKE_SCENARIOS)
    reports = []
    for seed in range(lo, hi):
        for name in names:
            reports.append(eng.run(
                name, seed=args.seed + seed, n_faults=args.faults,
                benign=not args.all_kinds, shrink=not args.no_shrink))
    return _finish(reports, eng, "soak")


def run_replay(args) -> int:
    eng = _engine(args)
    report = eng.replay(args.replay)
    print(json.dumps(report.to_dict(), indent=2, default=str))
    if report.failures:
        print(f"[chaos] failure REPRODUCED "
              f"({', '.join(f.oracle for f in report.failures)})",
              file=sys.stderr)
        return 1
    print("[chaos] schedule passed — the repro no longer fails",
          file=sys.stderr)
    return 0


def run_single(args) -> int:
    eng = _engine(args)
    names = args.scenario or list(SMOKE_SCENARIOS)
    reports = [
        eng.run(name, seed=args.seed, n_faults=args.faults,
                benign=not args.all_kinds, shrink=not args.no_shrink)
        for name in names
    ]
    return _finish(reports, eng, "single")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        return run_smoke(args)
    if args.soak:
        return run_soak(args)
    if args.replay:
        return run_replay(args)
    return run_single(args)


if __name__ == "__main__":
    raise SystemExit(main())
