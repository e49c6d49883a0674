"""Time the forward attention (``ops/attention.py::attention``,
``csrc/attention.cu``) on the card, beside SDPA on the same packed buffer and
the bound.

    python3 -m nans_clip_tpu_torch.bench_attention [--bwd | --flash | --flash-bwd] [--root DIR]

Prints the card's name and power limit, one line a shape, then one JSON
line. Shapes (batch, heads, S, head dim): ViT-B-16's image attention at
batch 256 (256, 12, 197, 64); RoBERTa-base's text attention at batch 256
with a key bias masking each sample's padding (256, 12, 52, 64); ViT-H-14's
(32, 16, 257, 80); ViT-L-14-336's (32, 16, 577, 64); and the text tower's
training forward at batch 128, masked, with probability dropout 0.1 (128,
12, 52, 64). For each: the mean ms of 20 launches after a warm-up (CUDA
events); ``F.scaled_dot_product_attention`` on the q, k, v views of the same
``[B*S, 3W]`` buffer with the same additive key bias (with ``dropout_p`` 0.1
where the kernel drops: a yardstick the port never calls); and the bound
max(bytes / 3.35 TB/s, flops / 989 TFLOP/s), q, k, v and the key bias read
once and ctx written once, 4 B S^2 H dh flops.

``--bwd`` times the backward (``ops/attention.py::attention_bwd``, the
one-shot kernel of ``csrc/attention.cu``, fp32 and bf16 dqkv as the
full-gradient chains take them) at the train step's shapes, ViT-B-16's
image attention (128, 12, 197, 64), RoBERTa-base's masked text attention
with probability dropout 0.1 (128, 12, 52, 64), ViT-H-14's (32, 16, 257,
80), ViT-L-14-336's (32, 16, 577, 64) and #20's at ViT-H width and 336
pixels (16, 16, 577, 80), the last two on the long-sequence pair of
kernels; where the wrapper takes the forward's row statistics (``stats``),
they are formed by one forward call outside the timed window, as the
chains form them in their forward recompute (a wrapper whose long pair
forms its own ignores them there); beside SDPA's backward
(``torch.autograd.grad`` through ``F.scaled_dot_product_attention`` with the
same mask and rate) and the bound: q, k, v, dctx and the key bias read once,
dqkv written in fp32 and bf16, 10 B S^2 H dh flops (the scores recomputed,
dV, dP, dQ, dK).

``--flash`` times #22, the flash forward of the ``pallas`` route
(``ops/attention.py::flash_fwd``, ``csrc/flash.cu``: o and the row
logsumexp), at chip_smoke.py phase 10's shapes (ViT-B-16 at batch 256,
RoBERTa-base masked, ViT-H-14, ViT-L-14-336, S 1024), q, k and v views of
one packed projection, beside SDPA on the same views and the bound: q, k,
v and the key bias read once, o and lse written once, 4 B S^2 H dh flops;
each also replayed from a CUDA graph (``graph_ms``: device time, the
wrapper's host work left out).

``--flash-bwd`` times #23, the flash backward of the ``pallas`` route
(``ops/attention.py::flash_bwd``: the dQ kernel, then the dK/dV kernel),
at the same shapes from the forward's o and lse, beside SDPA's backward
(``torch.autograd.grad`` through ``F.scaled_dot_product_attention`` on the
same q, k, v views and key bias) and the bound: q, k, v, o, do, the key
bias and lse read once, dq, dk and dv written once, 10 B S^2 H dh flops;
each also replayed from a CUDA graph (``graph_ms``).

``--outputs FILE`` runs the forward instead at OUTPUT_SHAPES, each from
inputs of its own fixed seed, twice (the second call must give the same
bits), and saves ctx and the row statistics to FILE; where FILE exists it
compares them with it bit for bit: with ``--root`` of the parent commit
first, then without, a schedule's change is shown to keep the kernel's
bits.

``--root DIR`` imports ``nans_clip_tpu_torch`` from the checkout DIR (for
example a ``git archive`` of the parent commit): run parent, change,
change, parent in one chip call. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import zlib

from nans_clip_tpu_torch.bench_gemm import (BF16_FLOPS, HBM_BYTES_PER_S, time_graph_ms, time_ms,
                                             use_checkout)

# (name, batch, heads, S, head dim, masked, dropout rate)
SHAPES = [("vit_b_16", 256, 12, 197, 64, False, 0.0),
          ("roberta_base_masked", 256, 12, 52, 64, True, 0.0),
          ("vit_h_14", 32, 16, 257, 80, False, 0.0),
          ("vit_l_14_336", 32, 16, 577, 64, False, 0.0),
          ("roberta_base_train_dropout", 128, 12, 52, 64, True, 0.1)]
BWD_SHAPES = [("vit_b_16_train", 128, 12, 197, 64, False, 0.0),
              ("roberta_base_train_dropout", 128, 12, 52, 64, True, 0.1),
              ("vit_h_14_train", 32, 16, 257, 80, False, 0.0),
              ("vit_l_14_336_train", 32, 16, 577, 64, False, 0.0),
              ("vit_h_width_336_train", 16, 16, 577, 80, False, 0.0)]
# --outputs: (name, batch, heads, S, head dim, masked, dropout rate, stats): the
# image and text forwards of the embed and train cells, ViT-H-14's, and the
# walk's instances of 16 key tiles and of heads of 80
OUTPUT_SHAPES = [("vit_b_16", 256, 12, 197, 64, False, 0.0, False),
                 ("roberta_base_masked", 256, 12, 52, 64, True, 0.0, False),
                 ("roberta_base_train_dropout", 128, 12, 52, 64, True, 0.1, True),
                 ("vit_b_16_train", 128, 12, 197, 64, False, 0.0, True),
                 ("vit_h_14", 32, 16, 257, 80, False, 0.0, False),
                 ("key_tiles_16_dropout", 48, 12, 256, 64, True, 0.1, True),
                 ("heads_of_80_masked", 256, 12, 200, 80, True, 0.0, True)]
# chip_smoke.py phase 10's FLASH_SHAPES: (name, batch, heads, S, head dim, masked)
FLASH_SHAPES = [("vit_b_16", 256, 12, 197, 64, False),
                ("roberta_base_masked", 256, 12, 52, 64, True),
                ("vit_h_14", 32, 16, 257, 80, False),
                ("vit_l_14_336", 32, 16, 577, 64, False),
                ("max_pallas_seq", 4, 16, 1024, 64, False)]


def bound_ms(b, h, s, dh, masked, bwd=False):
    """(ms, what bounds it) of one forward (or backward) attention over a
    packed buffer."""
    w = h * dh
    nbytes = b * s * (4 * w * 2 + (3 * w * 6 if bwd else 0)) + (b * s * 4 if masked else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (10 if bwd else 4) * b * h * s * s * dh / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--bwd", action="store_true", help="the backward instead")
    mode.add_argument("--flash", action="store_true", help="#22, the flash forward, instead")
    mode.add_argument("--flash-bwd", action="store_true",
                      help="#23, the flash backward, instead")
    mode.add_argument("--outputs", default=None,
                      help="save the forward's outputs to this file, or compare them with it")
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    args = ap.parse_args()
    if args.root:
        use_checkout(args.root)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: needs a CUDA device")
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.attention import attention

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"kernels from {attention.__module__}", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    if args.outputs:
        print(json.dumps({"bench_attention_outputs": outputs(torch, dev, args.outputs),
                          "device": torch.cuda.get_device_name(0), "power": smi}), flush=True)
        return
    if args.bwd or args.flash or args.flash_bwd:
        key, out = (("bench_attention_bwd", bench_bwd(torch, F, dev, g)) if args.bwd else
                    ("bench_flash_bwd", bench_flash_bwd(torch, F, dev, g)) if args.flash_bwd
                    else ("bench_flash_fwd", bench_flash(torch, F, dev, g)))
        print(json.dumps({key: out, "device": torch.cuda.get_device_name(0), "power": smi}),
              flush=True)
        return
    out = {}
    for name, b, h, s, dh, masked, rate in SHAPES:
        w = h * dh
        qkv = torch.randn(b * s, 3 * w, generator=g, device=dev).to(torch.bfloat16)
        kb = None
        if masked:
            lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
            keep = torch.arange(s, device=dev)[None, :] < lengths[:, None]
            kb = ((1.0 - keep.float()) * -10000.0).contiguous()
        dp = drop.Dropout(3, rate, drop.STREAM_ATTN, s) if rate else None
        ms = time_ms(torch, lambda: attention(qkv, kb, b, h, dp))
        q, k, v = qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
        mask = None if kb is None else kb.view(b, 1, 1, s).to(torch.bfloat16)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, scale=1.0 / math.sqrt(dh)))
        b_ms, b_by = bound_ms(b, h, s, dh, masked)
        print(f"{name}: ({b}, {h}, {s}, {dh}){' masked' if masked else ''}"
              f"{f' dropout {rate}' if rate else ''}: {ms:.4f} ms; SDPA {lib_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        out[name] = {"shape": [b, h, s, dh], "masked": masked, "dropout": rate, "ms": ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        del qkv
    print(json.dumps({"bench_attention": out, "device": torch.cuda.get_device_name(0),
                      "power": smi}), flush=True)


def outputs(torch, dev, path) -> dict:
    """The forward's ctx and statistics at OUTPUT_SHAPES: saved to ``path``,
    or compared bit for bit with those it holds."""
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.attention import attention

    got, out = {}, {}
    for name, b, h, s, dh, masked, rate, stats in OUTPUT_SHAPES:
        g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
        qkv = torch.randn(b * s, 3 * h * dh, generator=g, device=dev).to(torch.bfloat16)
        kb = None
        if masked:
            lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev)
            kb = ((torch.arange(s, device=dev)[None, :] >= lengths[:, None]).float()
                  * -10000.0).contiguous()
        dp = drop.Dropout(1234567, rate, drop.STREAM_ATTN, s) if rate else None
        calls = [attention(qkv, kb, b, h, dp, stats=stats) for _ in range(2)]
        # the bits, NaN payloads and signed zeros included: ctx, then the statistics
        first, second = ([None if t is None else
                          t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).cpu()
                          for t in (r if stats else (r, None))] for r in calls)
        got[name] = first
        out[name] = {"second_call_equal": all(a is None or torch.equal(a, c)
                                              for a, c in zip(first, second))}
        del qkv, calls
    if os.path.exists(path):
        saved = torch.load(path)
        for name, bits in got.items():
            out[name].update({f"{key}_equal": None if a is None else torch.equal(a, c)
                              for key, a, c in zip(("ctx", "stats"), bits, saved[name])})
    else:
        torch.save(got, path)
    for name, res in out.items():
        print(f"{name}: {res}", flush=True)
    return out


def bench_bwd(torch, F, dev, g) -> dict:
    """``attention_bwd`` at BWD_SHAPES, SDPA's backward beside it."""
    import inspect

    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.attention import attention, attention_bwd

    takes_stats = "stats" in inspect.signature(attention_bwd).parameters
    out = {}
    for name, b, h, s, dh, masked, rate in BWD_SHAPES:
        w = h * dh
        qkv = torch.randn(b * s, 3 * w, generator=g, device=dev).to(torch.bfloat16)
        dctx = torch.randn(b * s, w, generator=g, device=dev).to(torch.bfloat16)
        kb = None
        if masked:
            lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
            keep = torch.arange(s, device=dev)[None, :] < lengths[:, None]
            kb = ((1.0 - keep.float()) * -10000.0).contiguous()
        dp = drop.Dropout(3, rate, drop.STREAM_ATTN, s) if rate else None
        kw = {}
        if takes_stats:
            kw["stats"] = attention(qkv, kb, b, h, dp, stats=True)[1]
        ms = time_ms(torch, lambda: attention_bwd(qkv, dctx, kb, b, h, dp, **kw))
        q, k, v = (t.contiguous().requires_grad_() for t in
                   qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0))
        mask = None if kb is None else kb.view(b, 1, 1, s).to(torch.bfloat16)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=rate,
                                             scale=1.0 / math.sqrt(dh))
        gout = dctx.view(b, s, h, dh).transpose(1, 2)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(ctx, (q, k, v), gout,
                                                            retain_graph=True))
        b_ms, b_by = bound_ms(b, h, s, dh, masked, bwd=True)
        print(f"{name} backward: ({b}, {h}, {s}, {dh}){' masked' if masked else ''}"
              f"{f' dropout {rate}' if rate else ''}: {ms:.4f} ms; SDPA backward "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})", flush=True)
        out[name] = {"shape": [b, h, s, dh], "masked": masked, "dropout": rate, "ms": ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        del qkv, dctx, q, k, v, ctx
    return out


def bench_flash(torch, F, dev, g) -> dict:
    """``flash_fwd`` (#22) at FLASH_SHAPES, SDPA beside it."""
    from nans_clip_tpu_torch.ops.attention import flash_fwd

    out = {}
    for name, b, h, s, dh, masked in FLASH_SHAPES:
        q, k, v = torch.randn(b, s, 3, h, dh, generator=g, device=dev).to(
            torch.bfloat16).permute(2, 0, 3, 1, 4).unbind(0)
        kb = None
        if masked:
            lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
            kb = ((torch.arange(s, device=dev)[None, :] >= lengths[:, None]).float()
                  * -10000.0).contiguous()
        kern = lambda: flash_fwd(q, k, v, kb)
        mask = None if kb is None else kb.view(b, 1, 1, s).to(torch.bfloat16)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        ms, lib_ms = time_ms(torch, kern), time_ms(torch, lib)
        graph_ms, lib_graph_ms = time_graph_ms(torch, kern), time_graph_ms(torch, lib)
        nbytes = 4 * b * h * s * dh * 2 + b * h * s * 4 + (b * s * 4 if masked else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * b * h * s * s * dh / BF16_FLOPS * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"{name} flash forward: ({b}, {h}, {s}, {dh}){' masked' if masked else ''}: "
              f"{ms:.4f} ms (graph {graph_ms:.4f}); SDPA {lib_ms:.4f} ms (graph "
              f"{lib_graph_ms:.4f}); bound {b_ms:.4f} ms ({b_by})", flush=True)
        out[name] = {"shape": [b, h, s, dh], "masked": masked, "ms": ms, "graph_ms": graph_ms,
                     "library_ms": lib_ms, "library_graph_ms": lib_graph_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        del q, k, v
    return out


def bench_flash_bwd(torch, F, dev, g) -> dict:
    """``flash_bwd`` (#23) at FLASH_SHAPES, SDPA's backward beside it."""
    from nans_clip_tpu_torch.ops.attention import flash_bwd, flash_fwd

    out = {}
    for name, b, h, s, dh, masked in FLASH_SHAPES:
        q, k, v = torch.randn(b, s, 3, h, dh, generator=g, device=dev).to(
            torch.bfloat16).permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.randn(b, h, s, dh, generator=g, device=dev).to(torch.bfloat16)
        kb = None
        if masked:
            lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
            kb = ((torch.arange(s, device=dev)[None, :] >= lengths[:, None]).float()
                  * -10000.0).contiguous()
        o, lse = flash_fwd(q, k, v, kb)
        kern = lambda: flash_bwd(q, k, v, kb, o, do, lse)
        mask = None if kb is None else kb.view(b, 1, 1, s).to(torch.bfloat16)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
        lib = lambda: torch.autograd.grad(lout, (lq, lk, lv), do, retain_graph=True)
        ms, lib_ms = time_ms(torch, kern), time_ms(torch, lib)
        graph_ms = time_graph_ms(torch, kern)
        try:   # autograd's backward under graph capture: not every build takes it
            lib_graph_ms = time_graph_ms(torch, lib)
        except RuntimeError as err:
            print(f"{name}: SDPA backward not replayed from a graph ({err})", flush=True)
            lib_graph_ms = None
        nbytes = 8 * b * h * s * dh * 2 + b * h * s * 4 + (b * s * 4 if masked else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 10 * b * h * s * s * dh / BF16_FLOPS * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"{name} flash backward: ({b}, {h}, {s}, {dh}){' masked' if masked else ''}: "
              f"{ms:.4f} ms (graph {graph_ms:.4f}); SDPA backward {lib_ms:.4f} ms (graph "
              f"{lib_graph_ms}); bound {b_ms:.4f} ms ({b_by})", flush=True)
        out[name] = {"shape": [b, h, s, dh], "masked": masked, "ms": ms, "graph_ms": graph_ms,
                     "library_ms": lib_ms, "library_graph_ms": lib_graph_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        del q, k, v, do, o, lse, lq, lk, lv, lout
    return out


if __name__ == "__main__":
    main()
