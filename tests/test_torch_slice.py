"""The port's feature path (encode_image / encode_text / get_similarity)
against the JAX package's ``models.clip`` on the CPU, with identical weights
carried across by ``state_dict_from_jax_params``, and the reference ``.pt``
round trip through the port's ``load_from_name``.

fp32 on both sides. Tolerance atol = rtol = 2e-4 on the features: each
tower stacks its layers' fp32 sum-order differences (the sub-block
tolerance is 5e-5) and the final projections sum over up to 768 terms."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.tokenizer import tokenize as jtokenize
from nans_clip_tpu.utils.torch_interop import save_torch_checkpoint, state_dict_from_params
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.api import load_from_name
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=2e-4)
TEXTS = ["西湖美景", "南宋古籍善本,绍兴二十一年刊刻。", "a photo of a cat", "皮卡丘"]


def _cut(cfg, layers):
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=layers),
        text=dataclasses.replace(cfg.text, num_hidden_layers=layers))


def _port_cfg(jcfg):
    """The same configuration as the port's own dataclasses."""
    v, t = jcfg.vision, jcfg.text
    return tconfigs.CLIPConfig(
        embed_dim=jcfg.embed_dim,
        vision=tconfigs.VisionConfig(**dataclasses.asdict(v)),
        text=tconfigs.TextConfig(**dataclasses.asdict(t)), name=jcfg.name)


def _setup(jcfg, batch, seed=0):
    params, _ = jclip.init_clip(jax.random.PRNGKey(seed), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    cfg = _port_cfg(jcfg)
    model = build_clip(cfg)
    model.load_state_dict(state_dict_from_jax_params(params_np, cfg))
    rs = np.random.RandomState(seed)
    r = jcfg.vision.image_resolution
    images = rs.randn(batch, r, r, 3).astype(np.float32)
    ids = jtokenize((TEXTS * batch)[:batch])
    return params, model, images, ids


def _assert_slice_matches(jcfg, params, model, images, ids):
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images))
        txt = model.encode_text(torch.from_numpy(ids).long())
        li, lt = model.get_similarity(torch.from_numpy(images), torch.from_numpy(ids).long())
    np.testing.assert_allclose(img.numpy(), np.asarray(jclip.encode_image(params, jcfg, images)),
                               **TOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jclip.encode_text(params, jcfg, ids)),
                               **TOL)
    jli, jlt = jclip.get_similarity(params, jcfg, images, ids)
    # logits are cosines scaled by exp(logit_scale) = 14.3
    np.testing.assert_allclose(li.numpy(), np.asarray(jli), atol=3e-3, rtol=2e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(jlt), atol=3e-3, rtol=2e-4)


def test_tiny_slice_matches_jax():
    jcfg = jconfigs.tiny_config()
    _assert_slice_matches(jcfg, *_setup(jcfg, batch=3))


def test_base_width_slice_matches_jax():
    """ViT-B-16 + RoBERTa-base at full width, depth cut to 2 layers, batch 2."""
    jcfg = _cut(jconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"), 2)
    _assert_slice_matches(jcfg, *_setup(jcfg, batch=2, seed=1))


def test_reload_repacks_bert_qkv():
    """The text tower caches its packed q/k/v weights between forwards. New
    weights loaded into a model that has already run are packed anew (the
    features are the new JAX model's), and a cast repacks in the new dtype."""
    jcfg = jconfigs.tiny_config()
    _, model, images, ids = _setup(jcfg, batch=2, seed=2)
    sa = model.bert.encoder.layer[0].attention.self
    with torch.no_grad():
        model.encode_text(torch.from_numpy(ids).long())
        first = sa.packed()
        assert sa.packed()[0] is first[0]
    params, _ = jclip.init_clip(jax.random.PRNGKey(3), jcfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                                     _port_cfg(jcfg)))
    _assert_slice_matches(jcfg, params, model, images, ids)
    with torch.no_grad():
        assert sa.packed()[0] is not first[0]
        model.bfloat16()
        assert sa.packed()[0].dtype == torch.bfloat16
    assert sa.packed()[0].requires_grad   # with autograd on, nothing is cached


def test_reference_pt_round_trip(tmp_path, monkeypatch):
    """A reference-layout .pt written by the JAX package loads through the
    port's load_from_name and gives the JAX features. The tiny towers are
    named through model JSONs in a temporary config directory."""
    jcfg = jconfigs.tiny_config()
    v, t = jcfg.vision, jcfg.text
    (tmp_path / "Tiny-ViT.json").write_text(json.dumps({
        "embed_dim": jcfg.embed_dim, "image_resolution": v.image_resolution,
        "vision_layers": v.layers, "vision_width": v.width,
        "vision_patch_size": v.patch_size, "vision_head_width": v.head_width}))
    (tmp_path / "Tiny-BERT.json").write_text(json.dumps({
        "vocab_size": t.vocab_size, "text_hidden_size": t.hidden_size,
        "text_num_hidden_layers": t.num_hidden_layers,
        "text_num_attention_heads": t.num_attention_heads,
        "text_intermediate_size": t.intermediate_size, "text_hidden_act": t.hidden_act,
        "text_hidden_dropout_prob": t.hidden_dropout_prob,
        "text_attention_probs_dropout_prob": t.attention_probs_dropout_prob,
        "text_max_position_embeddings": t.max_position_embeddings,
        "text_type_vocab_size": t.type_vocab_size,
        "text_initializer_range": t.initializer_range}))
    monkeypatch.setattr(tconfigs, "CONFIG_DIR", tmp_path)

    params, _ = jclip.init_clip(jax.random.PRNGKey(4), jcfg)
    ckpt = tmp_path / "tiny.pt"
    save_torch_checkpoint(str(ckpt), state_dict_from_params(jax.tree.map(np.asarray, params), jcfg))
    model, preprocess = load_from_name(str(ckpt), vision_model_name="Tiny-ViT",
                                       text_model_name="Tiny-BERT",
                                       input_resolution=v.image_resolution)
    assert model.cfg.vision == tconfigs.VisionConfig(**dataclasses.asdict(v))
    rs = np.random.RandomState(4)
    images = rs.randn(2, v.image_resolution, v.image_resolution, 3).astype(np.float32)
    ids = jtokenize(TEXTS[:2])
    np.testing.assert_allclose(model.encode_image(images).numpy(),
                               np.asarray(jclip.encode_image(params, jcfg, images)), **TOL)
    np.testing.assert_allclose(model.encode_text(ids).numpy(),
                               np.asarray(jclip.encode_text(params, jcfg, ids)), **TOL)
    assert callable(preprocess)


def test_published_name_without_file_says_where(tmp_path):
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        load_from_name("ViT-B-16", download_root=str(tmp_path))
