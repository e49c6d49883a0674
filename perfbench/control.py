"""The control of a cell's correctness check: the plain reference put in
the program's place and computed one precision below the configuration's
(fp8 for bf16: E4M3 operands with a scale a tensor, E5M2 gradients, fp32
accumulation), judged by the same numbers a run compares, on each seed.
It has to come out not correct: the limits lie between a run's numbers
and these.

    python3 -m perfbench.control --workload embed-vitb16-b256 --seeds 1,2,3 [--seconds 30]

One JSON line a seed: ``{"seed", "numbers": {name: value}}``. A serving
cell's requests depend on ``--seconds`` (give the cell's run length).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from perfbench import harness

    harness.env_setup()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--fault", default=None,
                   help="a planted fault in place of the lower precision (train: half_batch)")
    args = p.parse_args(argv)
    import torch

    from perfbench.reference import model as ref_model

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    traffic = harness.traffic(cell["traffic"])
    seconds = args.seconds or bench["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell=cell, config=harness.config(cell["config"]), traffic=traffic,
                              limits=harness.limits(cell["name"]), seed=seed, seconds=seconds,
                              trace=False, device=torch.device("cuda", 0),
                              t_start=time.perf_counter())
        drv = harness.driver(traffic["kind"])
        numbers = (drv.control(ctx, ref_model.Precision("fp8")) if args.fault is None
                   else drv.control(ctx, None, args.fault))
        print(json.dumps({"workload": cell["name"], "seed": seed, "fault": args.fault,
                          "numbers": numbers}),
              flush=True)
        harness.free(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
