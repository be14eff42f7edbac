"""Run one cell of the benchmark of ``fia_tpu_torch``.

    python3 fiabench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted`` and ``failed`` jobs, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each compared number
beside its limit, which also close standard error. Exits non-zero, with
no result, without the CUDA cards the cell asks for, or where the JAX
package or JAX itself was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one host thread for every library: the run's host work then does not
# contend with itself on a machine whose cores are shared
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this script's folder, whose modules
# would otherwise shadow the standard library's
sys.path[0] = ROOT

#: top-level module names that must not be loaded by a run
BANNED = frozenset({"jax", "jaxlib", "flax", "fia_tpu"})


def loaded_banned() -> list[str]:
    """Banned top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fiabench import cell as cellmod
    from fiabench.spec import Spec

    spec = Spec(os.path.join(ROOT, "BENCHMARK.json"))
    chips = int(spec.workload(args.workload)["chips"])
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fiabench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    out = cellmod.run(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    out["device"].update(platform="gpu", kind=torch.cuda.get_device_name(0),
                         power_limit=power_limit())
    found = loaded_banned()
    if found:
        print(f"fiabench: loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
