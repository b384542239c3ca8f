"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, in bfloat16 (the precision below
the float32 the configurations state), on the requests a run compares.
A cell whose configuration names a driver takes that driver's
``control_readings`` (``lm_serve``: the reference with its weights
rounded to the precision below the configuration's, beside the
program's own reading).

    python3 detbench/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's first requests (four times its
requests in flight), draws the sample a run would compare among them,
and prints one JSON line: each compared number of the control beside the
limit.  A sound limit is failed by the control on every seed.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from detbench.harness import cell_driver, compare  # noqa: E402
from detbench.traffic import (Sampler, Traffic, load_config,  # noqa: E402
                              load_workload)


def control_readings(cell: str, seed: int, *, device: str,
                     root: Path = HERE) -> dict:
    """The control's worst errors on one seed, each beside its limit (a
    cell whose configuration names a driver: that driver's control)."""
    driver = cell_driver(cell, root)
    if driver is not None:
        return driver.control_readings(cell, seed, device=device, root=root)
    import torch
    workload = load_workload(cell, root)
    limits = load_config(workload.config, root)["guarantees"]
    n = 4 * (workload.outstanding or len(workload.shapes) * 64)
    t0 = time.perf_counter()
    traffic = Traffic(workload, seed)
    sampler = Sampler(traffic)
    for k in range(n):
        sampler.offer(k)
    worst = compare(workload, traffic, sampler.chosen(), device,
                    dtype=torch.bfloat16)
    compared = worst.pop("compared")
    return {"workload": cell, "seed": seed, "dtype": "bfloat16",
            "compared": compared, "seconds": time.perf_counter() - t0,
            "checks": {k: {"value": v, "limit": float(limits[k]),
                           "fails": not v <= float(limits[k])}
                       for k, v in worst.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        out = control_readings(args.workload, int(s), device=device)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
