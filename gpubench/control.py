"""The readings that a cell's output limits are set from, on the card.

    python3 gpubench/control.py --workload NAME --seeds 11,12,... \\
        --control-seeds 21,22,23 --seconds 5 --out chiprun_out/control_NAME.json

For each of --seeds, one run of the cell (a short window at the cell's own
load and sizes, then the output check): the program's readings, the worst
sampled output's numbers against the family's reference. For each of
--control-seeds, the control's readings: the family's reference in the
nearest precision below the configuration's, in the program's place
(`control_numbers` of gpubench/families/<family>.py). All in one process,
so the set-up is paid once a seed and the build once. Prints one JSON object
and writes it to --out.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gpubench import run as _run

    _run._set_cache_dirs()

import torch  # noqa: E402

from gpubench import manifest  # noqa: E402
from gpubench import run as R  # noqa: E402


def control_readings(cell, seed, device="cuda:0"):
    """The control's worst reading of each number its family computes."""
    nums = manifest.family(cell).control_numbers(cell.config, cell.traffic, seed, device)
    return {k: max(n[k] for n in nums) for k in nums[0]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        raise SystemExit(2)
    out = {"workload": args.workload, "program": {}, "control": {},
           "device": torch.cuda.get_device_name(0)}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        res = R.run_cell(cell, seed, args.seconds, False)
        out["program"][seed] = {**res["readings"], "correct": res["correct"],
                                "metrics": res["metrics"], "seconds": time.perf_counter() - t0}
        print(json.dumps({"seed": seed, **out["program"][seed]}), file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        out["control"][seed] = {**control_readings(cell, seed),
                                "seconds": time.perf_counter() - t0}
        print(json.dumps({"control_seed": seed, **out["control"][seed]}), file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
