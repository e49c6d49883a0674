"""Find the serving knee once: one set-up of a serving cell, then a window
at each offered rate, one JSON row a rate (requests, failures, p50 / p95 /
p99 ms, how long answers ran on after the last arrival, how late the
generator ran, samples a dispatch). The knee is the highest rate whose
answers keep pace with arrivals: nothing fails and the backlog drains
within a tenth of a second of the last arrival.

    python3 -m perfbench.sweep --config vith14-rbt-large --traffic serve-mixed-600 --seed 1 \\
        --seconds 8 --rates 200,400,600

(the configuration and the serving mix by name: the mix's own ``rate`` is not used).
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
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests a second")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    from perfbench.drivers import serve

    ctx = harness.Context(cell={}, config=harness.config(args.config),
                          traffic=harness.traffic(args.traffic), limits={}, seed=args.seed,
                          seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                          t_start=time.perf_counter())
    rows = serve.sweep(ctx, [float(r) for r in args.rates.split(",")], args.seconds)
    keep = [r["rate"] for r in rows if r["failed"] == 0 and r["drain_s"] < 0.1]
    print(json.dumps({"rows": rows, "knee": max(keep) if keep else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
