"""Operation and byte counts of the models the benchmark runs, and the
chip's published peaks: the yardstick of the per-layer metrics.

Frozen here so that a change to the program cannot move them. ``pair_flops``
is a copy of ``nans_clip_tpu_torch/bench.py::pair_flops`` (ViT towers only):
the forward's multiply-adds counted twice, layer by layer. The op lists
give, for each operation of the model's equations at a batch, its
operations and the bytes it must move with each input read once and each
output written once, whatever kernel computes it. A roofline share is the
sum over ops of ``max(flops / PEAK_FLOPS, bytes / PEAK_BYTES)`` over the
device's busy time; it reads the same work whatever kernels implement it.

All functions take a configuration dict as ``perfbench/configs/*.json``
holds it.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
PEAK_FLOPS = 989e12        # bf16 tensor cores, FLOP/s
PEAK_BYTES = 3.35e12       # HBM3, bytes/s

BF16, FP32 = 2, 4


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float

    def seconds(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def vision_seq(cfg: dict) -> int:
    g = cfg["image_resolution"] // cfg["vision_patch_size"]
    return g * g + 1


def _tower_flops(seq: int, width: int, layers: int) -> float:
    """Forward operations of one transformer tower a sample: QKV (6SW^2),
    attention (4S^2W), out-projection (2SW^2), 4x MLP (16SW^2) a layer."""
    return layers * (24.0 * seq * width * width + 4.0 * seq * seq * width)


def pair_flops(cfg: dict) -> float:
    """Forward operations of one (image, text) pair at the text context."""
    s_img, w, p = vision_seq(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    img = _tower_flops(s_img, w, cfg["vision_layers"])
    img += 2.0 * s_img * (3 * p * p) * w + 2.0 * w * cfg["embed_dim"]
    h = cfg["text_hidden_size"]
    txt = _tower_flops(cfg["context_length"], h, cfg["text_num_hidden_layers"])
    return img + txt + 2.0 * h * cfg["embed_dim"]


def image_flops(cfg: dict) -> float:
    s_img, w, p = vision_seq(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    return (_tower_flops(s_img, w, cfg["vision_layers"]) + 2.0 * s_img * (3 * p * p) * w
            + 2.0 * w * cfg["embed_dim"])


def text_flops(cfg: dict) -> float:
    h = cfg["text_hidden_size"]
    return (_tower_flops(cfg["context_length"], h, cfg["text_num_hidden_layers"])
            + 2.0 * h * cfg["embed_dim"])


def _gemm(name: str, m: int, k: int, n: int, bias: bool = True, extra_in: int = 0,
          e: int = BF16) -> Op:
    """[m, k] x [k, n] (+ bias) with ``extra_in`` more [m, n] inputs (a
    residual) read by its epilogue."""
    return Op(name, 2.0 * m * k * n, e * (m * k + k * n + m * n + (n if bias else 0)
                                          + extra_in * m * n))


def _ln(name: str, rows: int, width: int, e: int = BF16) -> Op:
    return Op(name, 0.0, e * (2 * rows * width + 2 * width))


def _attention(name: str, b: int, s: int, w: int, masked: bool, e: int = BF16) -> Op:
    """softmax(Q K^T / sqrt(dh) + bias) V over every head: q, k, v read,
    the context written (and the fp32 key bias read)."""
    return Op(name, 4.0 * b * s * s * w, e * 4 * b * s * w + (FP32 * b * s if masked else 0))


def image_ops(cfg: dict, b: int) -> List[Op]:
    """The image tower's forward at batch ``b``."""
    s, w, p = vision_seq(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    m = b * s
    ops = [_gemm("patch_embed", b * (s - 1), 3 * p * p, w, bias=False),
           Op("embed_add", 0.0, BF16 * (2 * m * w + s * w)), _ln("ln_pre", m, w)]
    for _ in range(cfg["vision_layers"]):
        ops += [_ln("ln_1", m, w), _gemm("qkv", m, w, 3 * w),
                _attention("attention", b, s, w, False), _gemm("out_proj", m, w, w, extra_in=1),
                _ln("ln_2", m, w), _gemm("fc1", m, w, 4 * w), _gemm("fc2", m, 4 * w, w, extra_in=1)]
    ops += [_ln("ln_post", b, w), _gemm("proj", b, w, cfg["embed_dim"], bias=False)]
    return ops


def text_ops(cfg: dict, b: int) -> List[Op]:
    """The text tower's forward at batch ``b`` and the context length."""
    s, h, inter = cfg["context_length"], cfg["text_hidden_size"], cfg["text_intermediate_size"]
    m = b * s
    ops = [Op("embed_gather", 0.0, BF16 * (2 * m * h + s * h + h) + 8 * m), _ln("ln_embed", m, h)]
    for _ in range(cfg["text_num_hidden_layers"]):
        ops += [_gemm("qkv", m, h, 3 * h), _attention("attention", b, s, h, True),
                _gemm("out_proj", m, h, h, extra_in=1), _ln("ln_attn", m, h),
                _gemm("fc1", m, h, inter), _gemm("fc2", m, inter, h, extra_in=1),
                _ln("ln_mlp", m, h)]
    ops += [_gemm("text_proj", b, h, cfg["embed_dim"], bias=False)]
    return ops


def backward_ops(forward: List[Op]) -> List[Op]:
    """The backward of each forward op: a product's input gradient and its
    fp32 weight gradient (each 2mkn), attention's four products (twice
    the forward's) with q, k, v, the context and its gradient read and the
    three gradients written, a LayerNorm's gradient (read dy and x, write
    dx), an elementwise op's gradient (its bytes again)."""
    out = []
    for op in forward:
        if op.name in ("attention",):
            out.append(Op(op.name + "_bwd", 2.0 * op.flops, op.bytes * 2))
        elif op.flops > 0:
            out.append(Op(op.name + "_dgrad", op.flops, op.bytes))
            out.append(Op(op.name + "_wgrad", op.flops, op.bytes))
        else:
            out.append(Op(op.name + "_bwd", 0.0, op.bytes * 1.5))
    return out


def n_params(cfg: dict) -> int:
    """Parameters of the CLIP (both towers, projections, logit scale)."""
    s, w, p, e = vision_seq(cfg), cfg["vision_width"], cfg["vision_patch_size"], cfg["embed_dim"]
    layer = lambda d, i: 4 * d * d + 4 * d + 2 * d * i + i + d + 4 * d
    vis = 3 * p * p * w + w + s * w + 4 * w + cfg["vision_layers"] * layer(w, 4 * w) + w * e
    h, inter = cfg["text_hidden_size"], cfg["text_intermediate_size"]
    txt = (cfg["vocab_size"] + cfg["text_max_position_embeddings"] + cfg["text_type_vocab_size"]
           ) * h + 2 * h + cfg["text_num_hidden_layers"] * layer(h, inter) + h * e
    return vis + txt + 1


def train_step_ops(cfg: dict, b: int) -> List[Op]:
    """One training step at batch ``b``: the fp32 masters cast to bf16, both
    forwards, their backwards, the loss, and AdamW over fp32 masters (read
    p, g, m, v; write p, m, v)."""
    fwd = image_ops(cfg, b) + text_ops(cfg, b)
    n = n_params(cfg)
    e = cfg["embed_dim"]
    loss = Op("loss", 4.0 * b * b * e, FP32 * (2 * b * e + 2 * b * b))
    return ([Op("cast", 0.0, (FP32 + BF16) * n)] + fwd + [loss] + backward_ops(fwd)
            + [Op("adamw", 12.0 * n, 7 * FP32 * n)])


def ops_seconds(ops: List[Op]) -> float:
    return math.fsum(op.seconds() for op in ops)
