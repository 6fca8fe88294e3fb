"""Readings for the comparison's limits, many seeds in one process.

    python3 -m gsbench.calibrate --workload <name> --seeds 1,2,3 \
        [--modes program,control,half] [--seconds 2]

For each seed, each mode's compared numbers against the reference:
``program`` the measured path (a short window), ``control`` the reference
computed in bfloat16 in the program's place, ``half`` the reference with
half of the image's rows left out of the loss (training cells). One JSON
line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from gsbench import cell as cells
from gsbench import harness
from gsbench.run import process_start, set_caches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gsbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    set_caches()
    import torch

    from gsbench.reference.gaussians import full_f32

    if not torch.cuda.is_available():
        print("gsbench: no CUDA device", file=sys.stderr)
        return 2
    full_f32()
    c = cells.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.Run(workload=args.workload, config=c.config, traffic=c.traffic, seed=seed,
                        seconds=args.seconds, trace=False,
                        device=torch.device("cuda", 0), started=process_start())
        res = c.entry.calibrate(r, args.modes.split(","))
        print(json.dumps(dict(workload=args.workload, seed=seed, **res)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
