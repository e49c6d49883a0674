"""Where the time of one whole-tower kernel launch goes, stage by stage.

    python3 -m nans_clip_tpu_torch.profile_tower [--batch 1,8,32] [--iters 3]

Runs ``ops/tower_kernel.py::fused_tower`` on ``cuda:0`` at ViT-B/16 and
RoBERTa-base shapes (12 layers, W = 768, I = 3072, 12 heads; image S = 197
pre-LN, text S = 52 post-LN), random bf16 weights from a seeded generator,
in bf16 and int8. The kernel writes the device clock (``%globaltimer``, ns)
after each grid barrier; this prints, for the last of ``--iters`` launches,
the total and each stage's mean microseconds (a layer's stages once a
layer; the pre-LN towers' first LayerNorm once), and one JSON line of all
of it.
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", default="1,8,32")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tower: needs a CUDA device")
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    from nans_clip_tpu_torch.utils.quantize import quantize_weight

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    n_layers, w, inter, heads = 12, 768, 3072, 12

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    layers = [(rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=0.02),
               rnd(3 * w, std=0.1), rnd(w, w, std=0.02), rnd(w, std=0.1),
               rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=0.02),
               rnd(inter, std=0.1), rnd(w, inter, std=0.01), rnd(w, std=0.1))
              for _ in range(n_layers)]
    q_layers = [tuple(quantize_weight(t) if i in (2, 4, 8, 10) else t for i, t in enumerate(p))
                for p in layers]
    result = {"device": torch.cuda.get_device_name(0), "runs": []}
    for form, s, post_ln in (("text", 52, True), ("image", 197, False)):
        names = tk.stage_names(n_layers, post_ln)
        for quant in (False, True):
            table = tk.TowerTable()
            for b in (int(v) for v in args.batch.split(",")):
                x = rnd(b, s, w)
                clock = torch.zeros(len(names) + 1, dtype=torch.int64, device=dev)
                for _ in range(args.iters):
                    tk.fused_tower(x, None, q_layers if quant else layers, heads, 1e-5,
                                   "gelu" if post_ln else "quick_gelu", post_ln, table,
                                   clock=clock)
                t = clock.tolist()   # waits for the launches
                stages = {}   # mean us of each stage over its occurrences
                for name, a, e in zip(names, t[:-1], t[1:]):
                    stages[name] = stages.get(name, 0.0) + (e - a) / 1e3 / names.count(name)
                run = {"form": form, "int8": quant, "batch": b, "total_us": (t[-1] - t[0]) / 1e3,
                       "us_a_layer": {k: round(v, 2) for k, v in stages.items()}}
                print(f"{form} {'int8' if quant else 'bf16'} b={b}: {run['total_us']:.1f} us; "
                      f"a layer: {run['us_a_layer']}", flush=True)
                result["runs"].append(run)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
