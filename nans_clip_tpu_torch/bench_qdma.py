"""Same-process batch-1 tower A/B on the card: bf16 weights (#4) against int8
weights converted in each K step (#5, "inline") and int8 weights converted
a layer ahead (#6, "qdma").

    python3 -m nans_clip_tpu_torch.bench_qdma [--iters 50]

The port of ``benchmarks/bench_qdma.py``: its two shapes (12 layers, W 768,
S 197, 12 heads, the ViT-B image shape; 24 layers, W 1024, S 52, 16 heads,
the RoBERTa-large text shape), its form (pre-LN, quick-GELU, no mask) and
its weights (0.05 x normal, from a seed; int8 by ``quantize_weight``), at
batch 1 on ``cuda:0``. Each arm is timed by CUDA events over ``--iters``
launches after a warm-up, twice, in the order bf16, inline, qdma, qdma,
inline, bf16; the ms of a tower is the mean of its two runs. The outputs are
compared across arms: qdma against inline at one grid (the smaller of their
two) must be bit-equal (the same bf16 weights, K-splits and mma order); the
max abs differences at each arm's own grid are printed. Prints the card's name and power limit,
then one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

# (label, layers, W, I, S, heads): benchmarks/bench_qdma.py's two shapes
SHAPES = [("ViT-B image 12L/768/S197", 12, 768, 3072, 197, 12),
          ("text-large 24L/1024/S52", 24, 1024, 4096, 52, 16)]
ARMS = ("bf16", "inline", "qdma")


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_qdma: needs a CUDA device")
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    from nans_clip_tpu_torch.utils.quantize import quantize_weight

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    f = lambda *shape: (0.05 * torch.randn(*shape, generator=g, device=dev)).to(torch.bfloat16)
    result = {"device": torch.cuda.get_device_name(0), "power": smi, "iters": args.iters,
              "shapes": []}
    for label, n_layers, w, inter, s, heads in SHAPES:
        layers = [(f(w), f(w), f(3 * w, w), f(3 * w), f(w, w), f(w), f(w), f(w), f(inter, w),
                   f(inter), f(w, inter), f(w)) for _ in range(n_layers)]
        q_layers = [tuple(quantize_weight(t) if i in (2, 4, 8, 10) else t
                          for i, t in enumerate(p)) for p in layers]
        x = torch.randn(1, s, w, generator=g, device=dev).to(torch.bfloat16)
        tables = {arm: tk.TowerTable() for arm in ARMS}
        call = {"bf16": lambda grid=None: tk.fused_tower(
                    x, None, layers, heads, 1e-5, "quick_gelu", False, tables["bf16"], grid),
                "inline": lambda grid=None: tk.fused_tower(
                    x, None, q_layers, heads, 1e-5, "quick_gelu", False, tables["inline"], grid),
                "qdma": lambda grid=None: tk.fused_tower(
                    x, None, q_layers, heads, 1e-5, "quick_gelu", False, tables["qdma"], grid,
                    quant_dma=True)}
        runs = {arm: [] for arm in ARMS}
        for arm in ARMS + ARMS[::-1]:
            runs[arm].append(_time_ms(call[arm], args.iters))
        ms = {arm: sum(v) / len(v) for arm, v in runs.items()}
        outs = {arm: call[arm]().float() for arm in ARMS}
        common = min(tk.max_grid(dev.index, tk.MODE_INT8, s),
                     tk.max_grid(dev.index, tk.MODE_QDMA, s))
        bit_equal = torch.equal(call["qdma"](common), call["inline"](common))
        if not bit_equal:
            raise SystemExit(f"bench_qdma: {label}: qdma is not bit-equal to inline at one grid")
        row = {"shape": label, "ms_per_tower": ms, "runs": runs,
               "inline_vs_bf16": ms["bf16"] / ms["inline"],
               "qdma_vs_bf16": ms["bf16"] / ms["qdma"],
               "qdma_vs_inline": ms["inline"] / ms["qdma"],
               "qdma_inline_maxdiff": float((outs["qdma"] - outs["inline"]).abs().max()),
               "inline_bf16_maxdiff": float((outs["inline"] - outs["bf16"]).abs().max()),
               "qdma_inline_bit_equal_at_one_grid": bit_equal}
        print(f"{label}: bf16 {ms['bf16']:.4f} ms, inline {ms['inline']:.4f} ms, qdma "
              f"{ms['qdma']:.4f} ms (qdma {row['qdma_vs_inline']:.3f}x of inline)", flush=True)
        result["shapes"].append(row)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
