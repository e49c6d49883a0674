"""Chinese BERT/RoBERTa text tower (counterpart of
``nans_clip_tpu/models/bert.py``).

Modules are named after the reference HF-lineage encoder
(cn_clip/clip/modeling_bert.py), so a reference state dict loads as it is:
word + position + token-type-0 embeddings with LayerNorm eps 1e-12,
post-LN self-attention and MLP sub-blocks with erf-GELU, the additive
``(1 - mask) * -10000`` key bias in fp32 (bert.py:82-84), and no pooler.
Each layer runs through the ported whole-layer kernel
(``ops/layer_kernel.py``) or its twin, as ``ops/gates.py`` routes. The
q/k/v weights are packed into the ``[3H, H]`` layout the kernels read once,
and packed again only when the weights change.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from nans_clip_tpu_torch.configs import TextConfig
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.layer_kernel import encoder_layer_math, fused_layer_block
from nans_clip_tpu_torch.ops.layernorm import layer_norm


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)


class BertSelfAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self._packed = None

    def packed(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """q|k|v as the kernels read them: weight [3H, H], bias [3H].

        Without autograd the packed pair is cached and rebuilt only when a
        source changes. The cache key is each source's address and version
        counter: a ``load_state_dict`` copies in place and bumps the version,
        a cast or a move gives a new address (the cache holds the old
        sources, so their addresses are not reused meanwhile)."""
        srcs = (self.query.weight, self.key.weight, self.value.weight,
                self.query.bias, self.key.bias, self.value.bias)
        if torch.is_grad_enabled():
            return torch.cat(srcs[:3]), torch.cat(srcs[3:])
        key = tuple((t.data_ptr(), t._version) for t in srcs)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, tuple(t.detach() for t in srcs),
                            torch.cat(srcs[:3]), torch.cat(srcs[3:]))
        return self._packed[2], self._packed[3]


class BertDenseLN(nn.Module):
    """``dense`` followed by a residual ``LayerNorm`` (BertSelfOutput and
    BertOutput share this layout)."""

    def __init__(self, d_in: int, h: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, h)
        self.LayerNorm = nn.LayerNorm(h, eps=eps)


class BertAttention(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg.hidden_size)
        self.output = BertDenseLN(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseLN(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        cfg = self.cfg
        ao, out = self.attention.output, self.output
        w_qkv, b_qkv = self.attention.self.packed()
        layer = fused_layer_block if use_kernel else encoder_layer_math
        return layer(x, ao.LayerNorm.weight, ao.LayerNorm.bias, w_qkv, b_qkv,
                     ao.dense.weight, ao.dense.bias, out.LayerNorm.weight, out.LayerNorm.bias,
                     self.intermediate.dense.weight, self.intermediate.dense.bias,
                     out.dense.weight, out.dense.bias, cfg.num_attention_heads,
                     cfg.layer_norm_eps, cfg.hidden_act, True, key_bias)


class BertEncoder(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class BertModel(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Normal(0, initializer_range) weights, zero biases, unit LayerNorms
        (``nans_clip_tpu.models.bert.init_bert``)."""
        std = self.cfg.initializer_range
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor],
                options: ModelOptions = ModelOptions()) -> torch.Tensor:
        """Sequence output [B, S, H]. ``attention_mask``: [B, S] 1=keep, 0=pad."""
        emb = self.embeddings
        s = input_ids.shape[1]
        x = emb.word_embeddings.weight[input_ids]
        x = x + emb.position_embeddings.weight[:s][None, :, :]
        x = x + emb.token_type_embeddings.weight[0][None, None, :]
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, self.cfg.layer_norm_eps)
        key_bias = None
        if attention_mask is not None:
            key_bias = ((1.0 - attention_mask.float()) * -10000.0).contiguous()
        use_kernel = gates.use_kernel(x, options.attn_impl)
        for layer in self.encoder.layer:
            x = layer(x, key_bias, use_kernel)
        return x
