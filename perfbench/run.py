"""One run of one benchmark cell of the port (``nans_clip_tpu_torch``) on
the card.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix by name, builds the program
with the seed's weights, warms up every shape the mix uses, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; last in it, ``checks``: each number compared with its
limit, which also end standard error. Without a card, or with fewer cards
than the cell asks for, it prints no result and exits 2; if JAX or the JAX
package was loaded, it exits 3.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nans_clip_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, device, t_start: float = T_START):
    """Run the cell on ``device``; returns (outcome, the result's metrics)."""
    from perfbench import harness

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    traffic = harness.traffic(cell["traffic"])
    ctx = harness.Context(cell=cell, config=harness.config(cell["config"]), traffic=traffic,
                          limits=harness.limits(cell["name"]), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), device=device,
                          t_start=t_start)
    outcome = harness.driver(traffic["kind"]).run(ctx)
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if harness.applies(m, cell["name"], bench):
                value = harness.reader(m["name"]).read(outcome.observations, outcome.trace)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if harness.applies(m, cell["name"], bench):
                metrics[m["name"]] = {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
    return outcome, metrics


def main(argv=None) -> int:
    from perfbench import harness

    harness.env_setup()
    args = parse_args(argv)
    import torch

    chips = harness.cell(harness.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), found {n}; no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    outcome, metrics = execute(args, device)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for note in outcome.notes:
        print(note, file=sys.stderr, flush=True)
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}}
    if args.trace and outcome.trace is not None:
        t = outcome.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t.device_ops],
                               "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
