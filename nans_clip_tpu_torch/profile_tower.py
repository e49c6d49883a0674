"""Where the time of one whole-tower kernel launch goes, stage by stage.

    python3 -m nans_clip_tpu_torch.profile_tower [--batch 1,8,32] [--iters 3]
        [--width 768|1024|1280[,...]] [--qdma] [--root DIR]

Runs ``ops/tower_kernel.py::fused_tower`` on ``cuda:0`` at the towers of
each width, random bf16 weights from a seeded generator, in bf16 and int8:
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
of it, with the card's name and power limit.

``--root DIR`` runs the same towers on the kernels of the checkout DIR too
(for example a ``git archive`` of the parent commit), in turns in one
process: DIR, this checkout, this checkout, DIR (each run tagged ``tree``
"root" or "this" in the JSON line). Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys

import torch

PKG = "nans_clip_tpu_torch"
# width -> [(form, S, post-LN, layers, heads)]
TOWERS = {768: [("text", 52, True, 12, 12), ("image", 197, False, 12, 12)],
          1024: [("text", 52, True, 24, 16), ("image", 257, False, 24, 16)],
          1280: [("image", 257, False, 32, 16)]}


def _load(root):
    """(tower_kernel, quantize, gates) of the checkout ``root``, or of this
    one (None), imported apart: the modules are taken out of sys.modules
    again, so that two checkouts can run in one process."""
    saved = {n: sys.modules.pop(n) for n in list(sys.modules) if n.split(".")[0] == PKG}
    if root:
        sys.path.insert(0, root)
    try:
        return tuple(importlib.import_module(f"{PKG}.{m}")
                     for m in ("ops.tower_kernel", "utils.quantize", "ops.gates"))
    finally:
        if root:
            sys.path.remove(root)
        for n in [n for n in sys.modules if n.split(".")[0] == PKG]:
            del sys.modules[n]
        sys.modules.update(saved)


def profile(mods, tree, widths, batches, iters, qdma):
    """The runs of every tower of ``widths`` on the modules ``mods``."""
    tk, quantize, gates = mods
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    runs = []
    for w in widths:
        g = torch.Generator(device=dev).manual_seed(0)
        inter = 4 * w

        def rnd(*shape, std=1.0, mean=0.0):
            return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

        arms = [("bf16", False), ("int8", False)]
        if qdma and gates.fits_tower_qdma(w):
            arms.append(("int8 qdma", True))
        for form, s, post_ln, n_layers, heads in TOWERS[w]:
            layers = [(rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=0.02),
                       rnd(3 * w, std=0.1), rnd(w, w, std=0.02), rnd(w, std=0.1),
                       rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=0.02),
                       rnd(inter, std=0.1), rnd(w, inter, std=0.01), rnd(w, std=0.1))
                      for _ in range(n_layers)]
            q_layers = [tuple(quantize.quantize_weight(t) if i in (2, 4, 8, 10) else t
                              for i, t in enumerate(p)) for p in layers]
            for arm, ahead in arms:
                names = tk.stage_names(n_layers, post_ln, ahead)
                table = tk.TowerTable()
                for b in batches:
                    x = rnd(b, s, w)
                    clock = torch.zeros(len(names) + 1, dtype=torch.int64, device=dev)
                    for _ in range(iters):
                        tk.fused_tower(x, None, layers if arm == "bf16" else q_layers, heads,
                                       1e-5, "gelu" if post_ln else "quick_gelu", post_ln, table,
                                       clock=clock, quant_dma=ahead)
                    t = clock.tolist()   # waits for the launches
                    stages = {}   # mean us of each stage over its occurrences
                    for name, a, e in zip(names, t[:-1], t[1:]):
                        stages[name] = stages.get(name, 0.0) + (e - a) / 1e3 / names.count(name)
                    mode = (tk.MODE_QDMA if ahead else tk.MODE_INT8 if arm == "int8"
                            else tk.MODE_BF16)
                    run = {"tree": tree, "form": form, "width": w, "arm": arm,
                           "layers": n_layers, "batch": b,
                           "grid": tk.max_grid(0, mode, s, w // heads),
                           "total_us": (t[-1] - t[0]) / 1e3,
                           "us_a_layer": {k: round(v, 2) for k, v in stages.items()}}
                    print(f"[{tree}] {form} W={w} {arm} b={b} (grid {run['grid']}): "
                          f"{run['total_us']:.1f} us; a layer: {run['us_a_layer']}", flush=True)
                    runs.append(run)
                    del x, clock
            del layers, q_layers
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", default="1,8,32")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--width", default="768", help="768, 1024, 1280, or a comma list")
    ap.add_argument("--qdma", action="store_true")
    ap.add_argument("--root", default=None, help="a checkout to run in turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tower: needs a CUDA device")
    widths = [int(v) for v in args.width.split(",")]
    if not set(widths) <= set(TOWERS):
        raise SystemExit(f"profile_tower: widths are {sorted(TOWERS)}")
    batches = [int(v) for v in args.batch.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    this = _load(None)
    order = [("this", this)]
    if args.root:
        root = _load(args.root)
        order = [("root", root), ("this", this), ("this", this), ("root", root)]
    result = {"device": torch.cuda.get_device_name(0), "power": smi, "widths": widths,
              "root": args.root, "runs": []}
    for tree, mods in order:
        result["runs"] += profile(mods, tree, widths, batches, args.iters, args.qdma)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
