"""A whole encoder layer through the hand-written Hopper kernels.

Port of ``nans_clip_tpu/ops/layer_kernel.py::_layer_kernel`` (:116), the
TPU kernel that ran both sub-blocks in one call through
``encoder_layer_math`` (:43). On this card it is the attention chain then
the MLP chain of ``ops/fused_block.py``; the intermediate hidden state is
in the io dtype between them, exactly as ``layer_kernel.py:92-94`` rounds
it. The post-LN form normalises with ``ln1`` after attention and ``ln2``
after the MLP.

``encoder_layer_math`` is the plain-torch twin; :func:`fused_layer_block`
runs it for CPU tensors and the kernels for CUDA tensors (or raises).
"""

from __future__ import annotations

from nans_clip_tpu_torch.ops.fused_block import (KERNEL_OPS, PLAIN_OPS, attention_chain,
                                                 mlp_chain)


def _layer(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1, w2, b2,
           heads, eps, act, post_ln, key_bias, ops):
    h = attention_chain(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, heads, eps, key_bias,
                        post_ln, ops)
    return mlp_chain(h, ln2_w, ln2_b, w1, b1, w2, b2, act, eps, post_ln, ops)


def encoder_layer_math(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1,
                       w2, b2, heads: int, eps: float = 1e-5, act: str = "quick_gelu",
                       post_ln: bool = False, key_bias=None):
    """Plain-torch twin of one layer.
    pre-LN: h = x + attn(LN1(x)); h + mlp(LN2(h)).
    post-LN: h = LN1(x + attn(x)); LN2(h + mlp(h)), additive key bias."""
    return _layer(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1, w2, b2,
                  heads, eps, act, post_ln, key_bias, PLAIN_OPS)


def fused_layer_block(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1,
                      w2, b2, heads: int, eps: float = 1e-5, act: str = "quick_gelu",
                      post_ln: bool = False, key_bias=None):
    """One transformer layer (both sub-blocks). x: [B, S, W]."""
    if not x.is_cuda:
        return encoder_layer_math(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b,
                                  w1, b1, w2, b2, heads, eps, act, post_ln, key_bias)
    out = _layer(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1, w2, b2,
                 heads, eps, act, post_ln, key_bias, KERNEL_OPS)
    fused_layer_block.launches += 1
    return out


fused_layer_block.launches = 0
