"""Chinese BERT/RoBERTa text tower (counterpart of
``nans_clip_tpu/models/bert.py``).

Modules are named after the reference HF-lineage encoder
(cn_clip/clip/modeling_bert.py), so a reference state dict loads as it is:
word + position + token-type-0 embeddings with LayerNorm eps 1e-12,
post-LN self-attention and MLP sub-blocks with erf-GELU, the additive
``(1 - mask) * -10000`` key bias in fp32 (bert.py:82-84), and no pooler.
The layers run as ``ops/gates.py`` routes them: at serving batches all of
them in one launch of the whole-tower kernel (``ops/tower_kernel.py``),
otherwise each through the whole-layer kernel (``ops/layer_kernel.py``), or
through the twins for CPU tensors. The tower's int8 weights
(``utils/quantize.py``) stream as they are into the tower kernel and are
dequantized on entry everywhere else. The q/k/v weights are packed into
the ``[3H, H]`` layout the kernels read once, and packed again only when
the weights change.

Under tensor parallelism (``options.tp`` > 1), before any other route,
every layer is the two post-LN TP sub-blocks of ``parallel/tp.py`` (the
JAX deterministic branch, bert.py:135-163: #11/#12 where
``gates.tp_impls`` says "fused", their twins otherwise). A training forward
with dropout under tp > 1 is JAX's unfused GSPMD path (bert.py:100-105:
``use_fused`` is False there): the same sub-blocks on their twins, with the
embedding dropout and each layer's two seeds drawn from the generator as
below, and the masks that one process draws (``parallel/tp.py``).

Under ``attn_impl="pallas"`` each layer is the JAX tower's unfused post-LN
branch (bert.py:246-262), in inference and training: LayerNorm, the
projections, the MLP and dropout in plain torch around the flash attention
of ``ops/attention.py`` (#22/#23; the plain attention under attention
dropout, as in JAX): :func:`_pallas_layer`. Otherwise a training forward
(``options.deterministic`` False) runs every layer
through the sub-block autograd Functions (#1 post-LN then #2 post-LN
forward; backward #16 and #18, or #15 and #17 where a weight is frozen or
``options.bwd_impl`` routes there). With a ``torch.Generator`` it drops out as
the JAX tower does (bert.py:77-80, :226-258): the embedding output in plain
torch, then per layer two int32 seeds drawn from the generator, one for the
attention sub-block (probability and hidden dropout) and one for the MLP
(hidden dropout); the kernels draw their masks from those seeds
(``ops/dropout.py``). The parameters are cast to the compute dtype on each
forward (``ModelOptions.cast``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nans_clip_tpu_torch.configs import TextConfig
from nans_clip_tpu_torch.models.common import ModelOptions, layer_entries, layers_from
from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.activations import ACT2FN, upcast
from nans_clip_tpu_torch.ops.attention import mha
from nans_clip_tpu_torch.ops.fused_block import attention_block_train, mlp_block_train
from nans_clip_tpu_torch.ops.layer_kernel import encoder_layer_math, fused_layer_block
from nans_clip_tpu_torch.ops.layernorm import layer_norm
from nans_clip_tpu_torch.ops.tower_kernel import TowerTable, fused_tower
from nans_clip_tpu_torch.parallel.mesh import model_group
from nans_clip_tpu_torch.parallel.tp import tp_attention_block, tp_mlp_block
from nans_clip_tpu_torch.utils.quantize import Int8Weight, dequantize_weight, is_quantized


def _pallas_layer(x, p, key_bias, heads: int, eps: float, act: str, seed_a=None, seed_m=None,
                  attn_drop: float = 0.0, hid_drop: float = 0.0) -> torch.Tensor:
    """The JAX tower's unfused post-LN layer (bert.py:246-262), the layer of
    ``attn_impl="pallas"``: ``LN(x + drop(mha(x)))`` with the flash attention
    (#22/#23) where ``gates.pallas_attention_route`` holds and the plain
    attention under attention-probability dropout, then ``LN(x +
    drop(fc2(act(fc1(x)))))``. LayerNorm, products and dropout in plain
    torch (XLA in JAX) with the port's keep masks drawn from ``seed_a``
    (attention probabilities and hidden) and ``seed_m`` (hidden); autograd
    differentiates all of it."""
    s = x.shape[1]
    a_drop, h_drop = drop.sub_block(seed_a, attn_drop, hid_drop, s)
    a = mha(x, *p[2:6], heads, key_bias, "pallas", a_drop)
    if drop.active(h_drop):
        a = drop.apply(a, h_drop)
    x = layer_norm(x + a, p[0], p[1], eps)
    h = F.linear(ACT2FN[act](F.linear(x, p[8], p[9])), p[10], p[11])
    _, m_drop = drop.sub_block(seed_m, 0.0, hid_drop, s)
    if drop.active(m_drop):
        h = drop.apply(h, m_drop)
    return layer_norm(x + h, p[6], p[7], eps)


def embed(input_ids, word, pos, token_type, ln_w, ln_b, eps: float, cast=lambda t: t):
    """Word + position + token-type-0 embeddings, then their LayerNorm:
    [B, S, H]; ``cast`` takes each weight to the compute dtype."""
    s = input_ids.shape[1]
    # F.embedding, not weight[input_ids]: the indexing backward
    # (index_put_ accumulating) adds repeated ids in a varying order on
    # the CPU, and a resumed run must give an uninterrupted run's bits
    x = cast(F.embedding(input_ids, word))
    x = x + cast(pos.narrow(0, 0, s)).unsqueeze(0)
    x = x + cast(token_type.select(0, 0)).view(1, 1, -1)
    return layer_norm(x, cast(ln_w), cast(ln_b), eps)


def key_bias_of(attention_mask: torch.Tensor) -> torch.Tensor:
    """The additive fp32 key bias ``(1 - mask) * -10000``, [B, S]."""
    return ((1.0 - attention_mask.float()) * -10000.0).contiguous()


def run_layers(cfg: TextConfig, x, key_bias, layers, options: ModelOptions,
               table: Optional[TowerTable] = None) -> torch.Tensor:
    """The deterministic layers at tp 1 as ``ops/gates.py`` routes them (the
    module docstring); ``table`` caches the tower kernel's pointer table."""
    heads, eps, act = cfg.num_attention_heads, cfg.layer_norm_eps, cfg.hidden_act
    if gates.pallas_route(options.attn_impl):
        for p in layers:
            p = tuple(dequantize_weight(t, x.dtype) if is_quantized(t) else t for t in p)
            x = _pallas_layer(x, p, key_bias, heads, eps, act)
        return x
    if gates.tower_route(x, options.attn_impl, "text", heads, cfg.intermediate_size,
                         is_quantized(layers[0][2]), options.tp):
        return fused_tower(x, key_bias, layers, heads, eps, act, True, table)
    layer_fn = fused_layer_block if gates.use_kernel(x, options.attn_impl) else encoder_layer_math
    for p in layers:
        p = tuple(dequantize_weight(t, x.dtype) if is_quantized(t) else t for t in p)
        x = layer_fn(x, *p, heads, eps, act, True, key_bias)
    return x


def serve(cfg: TextConfig, w: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor,
          options: ModelOptions) -> torch.Tensor:
    """The inference forward of :meth:`BertModel.forward` from its
    :meth:`~BertModel.serving_weights` ``w``: the same functions on the same
    values, with no cast or concatenation of a weight. Sequence output
    [B, S, H]."""
    x = embed(input_ids, w["word_embeddings"], w["position_embeddings"],
              w["token_type_embeddings"], w["ln.weight"], w["ln.bias"], cfg.layer_norm_eps)
    return run_layers(cfg, x, key_bias_of(attention_mask),
                      layers_from(w, cfg.num_hidden_layers), options)


def _layer_seeds(generator: Optional[torch.Generator]):
    """A layer's two dropout seeds (attention sub-block, MLP) drawn from
    ``generator``, or (None, None) without one."""
    if generator is None:
        return None, None
    return tuple(torch.randint(0, 2 ** 31 - 1, (2,), generator=generator).tolist())


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

    def reset_caches(self) -> None:
        self._packed = None

    def packed(self, dtype: Optional[torch.dtype] = None,
               fresh: bool = False) -> Tuple[object, torch.Tensor]:
        """q|k|v as the kernels read them: weight [3H, H] (an ``Int8Weight``
        when the three are quantized), bias [3H]; in ``dtype`` when given.

        Without autograd (and without ``fresh``) the packed pair is cached and rebuilt only when a
        source changes. The cache key is each source's address and version
        counter: a ``load_state_dict`` copies in place and bumps the version,
        a cast or a move gives a new address (the cache holds the old
        sources, so their addresses are not reused meanwhile)."""
        ws = (self.query.weight, self.key.weight, self.value.weight)
        srcs = tuple(t for w in ws for t in ((w.int8, w.scale) if is_quantized(w) else (w,)))
        srcs += (self.query.bias, self.key.bias, self.value.bias)
        if fresh or torch.is_grad_enabled():
            return _cast(_cat_weights(ws), dtype), _cast(torch.cat(srcs[-3:]), dtype)
        key = tuple((t.data_ptr(), t._version) for t in srcs) + (dtype,)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, tuple(t.detach() for t in srcs), _cast(_cat_weights(ws), dtype),
                            _cast(torch.cat(srcs[-3:]), dtype))
        return self._packed[2], self._packed[3]


def _cast(t, dtype):
    return t if dtype is None or not torch.is_tensor(t) else t.to(dtype)


def _cat_weights(ws):
    if is_quantized(ws[0]):
        return Int8Weight(torch.cat([w.int8 for w in ws]), torch.cat([w.scale for w in ws]))
    return torch.cat(ws)


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

    def weights(self, options: ModelOptions = ModelOptions(), fresh: bool = False) -> tuple:
        """The layer in ``encoder_layer_math``'s order, in the compute dtype;
        the four big weights are tensors or ``Int8Weight``s. ``fresh``: q|k|v
        packed anew, not from (or into) the packed cache (:meth:`packed`)."""
        ao, out, cast = self.attention.output, self.output, options.cast
        w_qkv, b_qkv = self.attention.self.packed(options.dtype, fresh)
        return (cast(ao.LayerNorm.weight), cast(ao.LayerNorm.bias), w_qkv, b_qkv,
                cast(ao.dense.weight), cast(ao.dense.bias), cast(out.LayerNorm.weight),
                cast(out.LayerNorm.bias), cast(self.intermediate.dense.weight),
                cast(self.intermediate.dense.bias), cast(out.dense.weight),
                cast(out.dense.bias))

    def tp_partial_parameters(self) -> tuple:
        """The parameters that the partial sub-blocks consume under tensor
        parallelism: the sliced weights and the q|k|v and fc1 biases (the
        post-LN LayerNorms run on the reduced value)."""
        sa = self.attention.self
        return (sa.query.weight, sa.query.bias, sa.key.weight, sa.key.bias, sa.value.weight,
                sa.value.bias, self.attention.output.dense.weight,
                self.intermediate.dense.weight, self.intermediate.dense.bias,
                self.output.dense.weight)


class BertEncoder(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.tower_table = TowerTable()


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
                options: ModelOptions = ModelOptions(),
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sequence output [B, S, H]. ``attention_mask``: [B, S] 1=keep, 0=pad.
        ``generator`` draws the dropout seeds of a training forward."""
        emb = self.embeddings
        x = embed(input_ids, emb.word_embeddings.weight, emb.position_embeddings.weight,
                  emb.token_type_embeddings.weight, emb.LayerNorm.weight, emb.LayerNorm.bias,
                  self.cfg.layer_norm_eps, options.cast)
        key_bias = None if attention_mask is None else key_bias_of(attention_mask)
        layers = [layer.weights(options) for layer in self.encoder.layer]
        if options.tp > 1:
            return self._tp_layers(x, key_bias, layers, options, generator)
        if not options.deterministic:
            return self._train_layers(x, key_bias, layers, options, generator)
        return run_layers(self.cfg, x, key_bias, layers, options, self.encoder.tower_table)

    def serving_weights(self, options: ModelOptions) -> dict:
        """The tensors of an inference forward, by name, in the compute
        dtype, q|k|v packed into ``[3H, H]`` (packed anew, not from the
        packed cache), the embedding LayerNorm, which the plain ``layer_norm``
        reads in fp32, in fp32: the inputs of :func:`serve`."""
        emb, cast = self.embeddings, options.cast
        w = {"word_embeddings": cast(emb.word_embeddings.weight),
             "position_embeddings": cast(emb.position_embeddings.weight),
             "token_type_embeddings": cast(emb.token_type_embeddings.weight),
             "ln.weight": upcast(cast(emb.LayerNorm.weight)),
             "ln.bias": upcast(cast(emb.LayerNorm.bias))}
        w.update(layer_entries([layer.weights(options, fresh=True)
                                for layer in self.encoder.layer]))
        return w

    def _tp_layers(self, x, key_bias, layers, options: ModelOptions,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """Every layer through the post-LN TP sub-blocks (JAX bert.py:135-163),
        each rank on its heads and MLP columns; in a training forward with a
        generator, with dropout on the twins (bert.py:100-105)."""
        cfg = self.cfg
        heads, eps, act = cfg.num_attention_heads, cfg.layer_norm_eps, cfg.hidden_act
        group = model_group(options.tp)
        dropout = not options.deterministic and generator is not None
        x, hd, ad = self._embedding_dropout(x, generator if dropout else None)
        a_impl, m_impl = ("xla", "xla") if dropout else gates.tp_impls(x, options.attn_impl, act)
        for p in layers:
            p = tuple(dequantize_weight(t, x.dtype) if is_quantized(t) else t for t in p)
            seed_a, seed_m = _layer_seeds(generator if dropout else None)
            x = tp_attention_block(x, *p[:6], heads, options.tp, eps, True, key_bias, a_impl,
                                   group, seed_a, ad, hd)
            x = tp_mlp_block(x, *p[6:], act, options.tp, eps, True, m_impl, group, seed_m, hd)
        return x

    def _embedding_dropout(self, x, generator: Optional[torch.Generator]):
        """(x, hidden rate, attention rate): the embedding output's dropout
        and the rates of the layers when a generator is given
        (bert.py:77-80), else x and zero rates."""
        if generator is None:
            return x, 0.0, 0.0
        hd, ad = self.cfg.hidden_dropout_prob, self.cfg.attention_probs_dropout_prob
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
        return drop.apply(x, drop.Dropout(seed, hd, drop.STREAM_EMBED, x.shape[1])), hd, ad

    def _train_layers(self, x, key_bias, layers, options: ModelOptions,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """The training forward of the layers, with dropout when a generator
        is given (bert.py:77-80, :233-258)."""
        cfg = self.cfg
        heads, eps, act = cfg.num_attention_heads, cfg.layer_norm_eps, cfg.hidden_act
        x, hd, ad = self._embedding_dropout(x, generator)
        use_kernel = gates.use_kernel(x, options.attn_impl)
        pallas = gates.pallas_route(options.attn_impl)
        route_a = gates.bwd_route("attn_post", options.bwd_impl)
        route_m = gates.bwd_route("mlp_post", options.bwd_impl)
        for p in layers:
            p = tuple(dequantize_weight(t, x.dtype) if is_quantized(t) else t for t in p)
            seed_a, seed_m = _layer_seeds(generator)
            if pallas:
                x = _pallas_layer(x, p, key_bias, heads, eps, act, seed_a, seed_m, ad, hd)
                continue
            x = attention_block_train(x, *p[:6], key_bias, heads, eps, True, seed_a, ad, hd,
                                      use_kernel, route_a)
            x = mlp_block_train(x, *p[6:], act, eps, True, seed_m, hd, use_kernel, route_m)
        return x
