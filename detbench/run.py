"""Run one cell of the benchmark once and print its result line.

    python3 detbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the cell's workload file names its traffic
and configuration (``detbench/workloads/<cell>.json``,
``detbench/configs/<config>.json``), ``BENCHMARK.json`` its metrics.
Without as many cards as the cell asks for, or with JAX loaded once the
window has closed, it prints no result and exits with another code
than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's or the JAX package's (compared whole: ``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible: no result",
              file=sys.stderr)
        return 3
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from detbench import harness
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), bench=bench, device="cuda",
                           t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package loaded in this process: {found}; "
              "no result", file=sys.stderr)
        return 4
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
