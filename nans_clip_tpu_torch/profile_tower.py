"""Where the time of one whole-tower kernel launch goes, stage by stage.

    python3 -m nans_clip_tpu_torch.profile_tower [--batch 1,8,32] [--iters 3]
        [--width 768|1024|1280] [--qdma]

Runs ``ops/tower_kernel.py::fused_tower`` on ``cuda:0`` at the towers of
one width, random bf16 weights from a seeded generator, in bf16 and int8:
W 768 (default) the ViT-B/16 image tower (12 layers, S 197, pre-LN) and the
RoBERTa-base text tower (12 layers, S 52, post-LN); W 1024 the ViT-L/14
image tower (24 layers, S 257) and the RoBERTa-large text tower (24 layers,
S 52); W 1280 the ViT-H/14 image tower (32 layers, S 257, heads of 80).
``--qdma`` adds the dequant-ahead int8 instance (#6, W <= 1024), whose
prologue converts layer 0 and whose later layers' conversions run in the
attention and row stages of the layer before. The kernel writes the device clock
(``%globaltimer``, ns) after each grid barrier; this prints, for the last
of ``--iters`` launches, the total and each stage's mean microseconds (a
layer's stages once a layer; the prologue once), and one JSON line of all
of it.
"""

from __future__ import annotations

import argparse
import json

import torch

# width -> [(form, S, post-LN, layers, heads)]
TOWERS = {768: [("text", 52, True, 12, 12), ("image", 197, False, 12, 12)],
          1024: [("text", 52, True, 24, 16), ("image", 257, False, 24, 16)],
          1280: [("image", 257, False, 32, 16)]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", default="1,8,32")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--width", type=int, default=768, choices=sorted(TOWERS))
    ap.add_argument("--qdma", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tower: needs a CUDA device")
    from nans_clip_tpu_torch.ops import gates
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    from nans_clip_tpu_torch.utils.quantize import quantize_weight

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    w = args.width
    inter = 4 * w

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    arms = [("bf16", False), ("int8", False)]
    if args.qdma and gates.fits_tower_qdma(w):
        arms.append(("int8 qdma", True))
    result = {"device": torch.cuda.get_device_name(0), "width": w, "runs": []}
    for form, s, post_ln, n_layers, heads in TOWERS[w]:
        layers = [(rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=0.02),
                   rnd(3 * w, std=0.1), rnd(w, w, std=0.02), rnd(w, std=0.1),
                   rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=0.02),
                   rnd(inter, std=0.1), rnd(w, inter, std=0.01), rnd(w, std=0.1))
                  for _ in range(n_layers)]
        q_layers = [tuple(quantize_weight(t) if i in (2, 4, 8, 10) else t
                          for i, t in enumerate(p)) for p in layers]
        for arm, qdma in arms:
            names = tk.stage_names(n_layers, post_ln, qdma)
            table = tk.TowerTable()
            for b in (int(v) for v in args.batch.split(",")):
                x = rnd(b, s, w)
                clock = torch.zeros(len(names) + 1, dtype=torch.int64, device=dev)
                for _ in range(args.iters):
                    tk.fused_tower(x, None, layers if arm == "bf16" else q_layers, heads, 1e-5,
                                   "gelu" if post_ln else "quick_gelu", post_ln, table,
                                   clock=clock, quant_dma=qdma)
                t = clock.tolist()   # waits for the launches
                stages = {}   # mean us of each stage over its occurrences
                for name, a, e in zip(names, t[:-1], t[1:]):
                    stages[name] = stages.get(name, 0.0) + (e - a) / 1e3 / names.count(name)
                mode = tk.MODE_QDMA if qdma else tk.MODE_INT8 if arm == "int8" else tk.MODE_BF16
                run = {"form": form, "arm": arm, "layers": n_layers, "batch": b,
                       "grid": tk.max_grid(0, mode, s, w // heads),
                       "total_us": (t[-1] - t[0]) / 1e3,
                       "us_a_layer": {k: round(v, 2) for k, v in stages.items()}}
                print(f"{form} W={w} {arm} b={b} (grid {run['grid']}): "
                      f"{run['total_us']:.1f} us; a layer: "
                      f"{run['us_a_layer']}", flush=True)
                result["runs"].append(run)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
