"""The port's HF interop, positional-embedding resize and ``.safetensors``
IO (``utils/hf_interop.py``, ``utils/torch_interop.py::resize_pos_embed``,
``utils/safetensors_io.py``) against the JAX package, ``transformers`` and
``safetensors`` on the CPU.

Tolerances: features atol = rtol = 2e-4 and logits 2e-3, as
``tests/test_hf_interop.py`` holds the JAX package against
``transformers.ChineseCLIPModel`` (fp32 on every side, sum orders differ);
the resize within 1e-5 of max|pos| (both sides run the same float64
matrices); the key maps, configs and ``.safetensors`` bytes exactly."""

import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from nans_clip_tpu import api as japi
from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.utils import hf_interop as jhf
from nans_clip_tpu.utils import torch_interop as jti
from nans_clip_tpu_torch import api
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.utils import hf_interop as hf
from nans_clip_tpu_torch.utils import safetensors_io as st
from nans_clip_tpu_torch.utils.torch_interop import (normalize_state_dict, resize_pos_embed,
                                                     state_dict_from_jax_params)

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=2e-4)
JOPTS = JOptions(attn_impl="xla")
TINY = "tiny@tiny"


def _hf_config():
    from transformers import ChineseCLIPConfig, ChineseCLIPTextConfig, ChineseCLIPVisionConfig
    tc = ChineseCLIPTextConfig(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                               num_attention_heads=2, intermediate_size=128,
                               max_position_embeddings=32, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    vc = ChineseCLIPVisionConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                                 intermediate_size=256, image_size=32, patch_size=16)
    return ChineseCLIPConfig(text_config=tc.to_dict(), vision_config=vc.to_dict(),
                             projection_dim=48)


def _hf_model():
    from transformers import ChineseCLIPModel
    torch.manual_seed(0)
    return ChineseCLIPModel(_hf_config()).float().eval()


def _inputs(b=3, r=32):
    rs = np.random.RandomState(0)
    img = rs.randn(b, 3, r, r).astype(np.float32)
    txt = np.zeros((b, 16), np.int64)
    for i, n in enumerate((16, 10, 5)[:b]):   # padded rows too
        txt[i, 0] = 101
        txt[i, 1:n - 1] = rs.randint(10, 100, n - 2)
        txt[i, n - 1] = 102
    return img, txt


def _hf_outputs(model, img, txt):
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(txt), pixel_values=torch.from_numpy(img),
                    attention_mask=torch.from_numpy((txt != 0).astype(np.int64)))
        return model.get_image_features(torch.from_numpy(img)).numpy(), out


def _port_features(m, img, txt):
    nhwc = img.transpose(0, 2, 3, 1)
    li, _ = m.get_similarity(nhwc, txt)
    return m.encode_image(nhwc).numpy(), m.encode_text(txt).numpy(), li.numpy()


def _jax_features(cfg, params, img, txt):
    params = jax.tree.map(jax.numpy.asarray, params)
    nhwc = img.transpose(0, 2, 3, 1)
    return (np.asarray(jclip.encode_image(params, cfg, nhwc, JOPTS)),
            np.asarray(jclip.encode_text(params, cfg, txt.astype(np.int32), JOPTS)))


# -- the positional-embedding resize ---------------------------------------

@pytest.mark.parametrize("grid", [24, 7])
def test_resize_pos_embed_matches_jax(grid):
    pos = np.random.RandomState(0).randn(197, 768).astype(np.float32)
    ours = resize_pos_embed(pos, grid)
    ref = jti.resize_pos_embed(pos, grid)
    assert ours.shape == (grid * grid + 1, 768) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(pos).max())
    np.testing.assert_array_equal(ours[0], pos[0])   # the class row is kept


@pytest.fixture()
def tiny_pt(tmp_path, monkeypatch):
    """A tiny_config() reference .pt at 32 px, and "tiny@tiny" resolving to
    tiny_config() in both packages' APIs."""
    monkeypatch.setattr(japi, "load_config", lambda name: jconfigs.tiny_config())
    monkeypatch.setattr(api, "load_config", lambda name: tconfigs.tiny_config())
    cfg = jconfigs.tiny_config()
    params, _ = jclip.init_clip(jax.random.PRNGKey(3), cfg)
    path = str(tmp_path / "tiny32.pt")
    jti.save_torch_checkpoint(path, jti.state_dict_from_params(jax.tree.map(np.asarray, params),
                                                               cfg))
    return path


@pytest.mark.parametrize("entry", ["create_model", "load_from_name", "load"])
def test_checkpoint_at_another_grid_loads(tiny_pt, entry):
    """A 32 px checkpoint in a 64 px model: the positional embedding is
    resized on load (it raised a size mismatch before), and the features
    equal JAX's ``create_model(..., input_resolution=64)``."""
    jm = japi.create_model(TINY, tiny_pt, input_resolution=64, options=JOPTS)
    if entry == "create_model":
        m = api.create_model(TINY, tiny_pt, input_resolution=64, device="cpu")
    elif entry == "load_from_name":
        m, preprocess = api.load_from_name(tiny_pt, vision_model_name="tiny",
                                           text_model_name="tiny", input_resolution=64,
                                           device="cpu")
    else:
        m = api.load(api.create_model(TINY, input_resolution=64, seed=1, device="cpu"),
                     clip_path=tiny_pt, bert_path=tiny_pt)
    assert m.module.visual.positional_embedding.shape == (17, 64)
    img = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(m.encode_image(img).numpy(), np.asarray(jm.encode_image(img)),
                               **TOL)


# -- HF key maps and configs ------------------------------------------------

def test_hf_to_reference_equals_jax():
    sd = _hf_model().state_dict()
    ours, ref = hf.hf_to_reference_state_dict(sd), jhf.hf_to_reference_state_dict(sd)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    # every .pt loader detects the layout, as JAX's normalize_state_dict does
    norm, jnorm = normalize_state_dict(sd), jti.normalize_state_dict(sd)
    assert set(norm) == set(jnorm)
    for k in jnorm:
        np.testing.assert_array_equal(norm[k].numpy(), jnorm[k], err_msg=k)


def test_reference_to_hf_equals_jax_and_round_trips():
    cfg = jconfigs.tiny_config()
    params, _ = jclip.init_clip(jax.random.PRNGKey(1), cfg)
    ref_sd = jti.state_dict_from_params(jax.tree.map(np.asarray, params), cfg)
    ours, theirs = hf.reference_to_hf_state_dict(ref_sd), jhf.reference_to_hf_state_dict(ref_sd)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)
    back = hf.hf_to_reference_state_dict(ours)
    assert set(back) == set(ref_sd)
    for k in ref_sd:
        np.testing.assert_array_equal(back[k].numpy(), ref_sd[k], err_msg=k)


def test_hf_refusals_equal_jax():
    with pytest.raises(KeyError, match="unmapped"):
        hf.hf_to_reference_state_dict({"vision_model.mystery.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="incomplete q/k/v"):
        hf.hf_to_reference_state_dict(
            {"vision_model.encoder.layers.0.self_attn.q_proj.weight": torch.zeros(2, 2)})
    with pytest.raises(KeyError, match="cannot map"):
        hf.reference_to_hf_state_dict({"visual.attnpool.c_proj.weight": torch.zeros(2)})
    ref_keys = {f"visual.transformer.resblocks.{i}.attn.Wqkv.weight": 0 for i in range(10)}
    ref_keys.update({f"bert.encoder.layer.{i}.attention.self.query.weight": 0
                     for i in range(10)})
    hf_keys = {f"vision_model.encoder.layers.{i}.self_attn.q_proj.weight": 0 for i in range(10)}
    hf_keys["text_projection.weight"] = 0
    for case in (ref_keys, {}, dict(ref_keys, **{"vision_model.embeddings.class_embedding": 0}),
                 hf_keys, dict(hf_keys, **{"visual.stray": 0})):
        assert hf.is_hf_layout(case) == jhf.is_hf_layout(case)
    assert hf.is_hf_layout(hf_keys) and not hf.is_hf_layout(ref_keys)


def test_configs_equal_jax():
    hf_cfg = _hf_config().to_dict()
    assert dataclasses.asdict(hf.config_from_hf(hf_cfg)) == \
        dataclasses.asdict(jhf.config_from_hf(hf_cfg))
    for struct in ("ViT-B-16@RoBERTa-wwm-ext-base-chinese", "ViT-H-14@RBT3-chinese"):
        assert hf.config_to_hf(tconfigs.load_config(struct)) == \
            jhf.config_to_hf(jconfigs.load_config(struct))
    bad = json.loads(json.dumps(hf_cfg))
    bad["vision_config"]["hidden_act"] = "gelu"
    with pytest.raises(ValueError, match="quick_gelu"):
        hf.config_from_hf(bad)
    with pytest.raises(ValueError, match="ResNet"):
        hf.config_to_hf(tconfigs.load_config("RN50@RBT3-chinese"))


# -- HF snapshots -------------------------------------------------------------

def test_load_from_name_hf_snapshot(tmp_path):
    """A transformers ``save_pretrained`` directory through the port's
    ``load_from_name`` (it raised "not found" before): features and logits
    as transformers' and as JAX's ``load_from_name`` of the same directory."""
    model = _hf_model()
    model.save_pretrained(tmp_path)
    m, _ = api.load_from_name(str(tmp_path), device="cpu")
    jm, _ = japi.load_from_name(str(tmp_path), options=JOPTS)
    assert m.image_resolution == 32
    img, txt = _inputs()
    ref_img, out = _hf_outputs(model, img, txt)
    ours_img, ours_txt, li = _port_features(m, img, txt)
    np.testing.assert_allclose(ours_img, ref_img, **TOL)
    np.testing.assert_allclose(ours_txt / np.linalg.norm(ours_txt, axis=-1, keepdims=True),
                               out.text_embeds.numpy(), **TOL)
    np.testing.assert_allclose(li, out.logits_per_image.numpy(), atol=2e-3, rtol=2e-3)
    j_img, j_txt = _jax_features(jm.cfg, jm.params, img, txt)
    np.testing.assert_allclose(ours_img, j_img, **TOL)
    np.testing.assert_allclose(ours_txt, j_txt, **TOL)

    # another resolution resizes the positional embedding, as JAX's
    m2, preprocess = api.load_from_name(str(tmp_path), input_resolution=64, device="cpu")
    jm2, _ = japi.load_from_name(str(tmp_path), input_resolution=64, options=JOPTS)
    assert m2.image_resolution == 64 and m2.module.visual.positional_embedding.shape[0] == 17
    img64 = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(m2.encode_image(img64).numpy(),
                               np.asarray(jm2.encode_image(img64)), **TOL)

    for kw in ({"vision_model_name": "ViT-B-16"},
               {"text_model_name": "RoBERTa-wwm-ext-base-chinese"}):
        with pytest.raises(ValueError, match="cannot override"):
            api.load_from_name(str(tmp_path), device="cpu", **kw)


def test_hf_state_dict_through_load(tmp_path):
    """An HF-layout ``.pt`` through ``api.load`` (both towers from it)."""
    model = _hf_model()
    path = str(tmp_path / "hf.pt")
    torch.save(model.state_dict(), path)
    cfg = hf.config_from_hf(_hf_config().to_dict())
    m = api.load(api.model_from_config(cfg, seed=5, device="cpu"), clip_path=path,
                 bert_path=path)
    m.module.text_projection.data.copy_(model.text_projection.weight.detach().T)
    img, txt = _inputs()
    ref_img, out = _hf_outputs(model, img, txt)
    ours_img, ours_txt, li = _port_features(m, img, txt)
    np.testing.assert_allclose(ours_img, ref_img, **TOL)
    np.testing.assert_allclose(li, out.logits_per_image.numpy(), atol=2e-3, rtol=2e-3)


def test_jax_snapshot_loads_in_the_port(tmp_path):
    """A directory JAX's ``save_hf_checkpoint`` wrote: the port's features
    within 2e-4 of JAX's ``load_hf_checkpoint``'s."""
    cfg = jconfigs.tiny_config()
    params, _ = jclip.init_clip(jax.random.PRNGKey(4), cfg)
    jhf.save_hf_checkpoint(str(tmp_path), jax.tree.map(np.asarray, params), cfg)
    jparams, jcfg = jhf.load_hf_checkpoint(str(tmp_path))
    sd, tcfg = hf.load_hf_checkpoint(str(tmp_path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    m, _ = api.load_from_name(str(tmp_path), device="cpu")
    img, txt = _inputs()
    ours_img, ours_txt, _ = _port_features(m, img, txt)
    j_img, j_txt = _jax_features(jcfg, jparams, img, txt)
    np.testing.assert_allclose(ours_img, j_img, **TOL)
    np.testing.assert_allclose(ours_txt, j_txt, **TOL)


def test_port_snapshot_loads_in_jax_and_transformers(tmp_path):
    from transformers import ChineseCLIPModel, ChineseCLIPProcessor

    import nans_clip_tpu_torch as nct

    assert nct.save_hf_checkpoint is hf.save_hf_checkpoint
    assert nct.load_hf_checkpoint is hf.load_hf_checkpoint
    cfg = tconfigs.tiny_config()
    m = api.model_from_config(cfg, seed=6, device="cpu")
    nct.save_hf_checkpoint(str(tmp_path), m, cfg)
    for name in ("config.json", "model.safetensors", "vocab.txt", "tokenizer_config.json",
                 "preprocessor_config.json"):
        assert os.path.isfile(tmp_path / name), name
    model, info = ChineseCLIPModel.from_pretrained(str(tmp_path), output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"], info
    ChineseCLIPProcessor.from_pretrained(str(tmp_path))
    img, txt = _inputs(2)
    ref_img, out = _hf_outputs(model.float().eval(), img, txt)
    ours_img, ours_txt, li = _port_features(m, img, txt)
    np.testing.assert_allclose(ours_img, ref_img, **TOL)
    np.testing.assert_allclose(li, out.logits_per_image.numpy(), atol=2e-3, rtol=2e-3)
    jparams, jcfg = jhf.load_hf_checkpoint(str(tmp_path))
    j_img, j_txt = _jax_features(jcfg, jparams, img, txt)
    np.testing.assert_allclose(ours_img, j_img, **TOL)
    np.testing.assert_allclose(ours_txt, j_txt, **TOL)
    # the port's snapshot is JAX's from the same weights: the same files, the
    # same tensors (JAX's writer stores the scalar logit_scale as [1], HF and
    # the port as [])
    jdir = tmp_path / "jax"
    same, _ = jti.params_from_state_dict({k: v.numpy() for k, v in
                                          m.module.state_dict().items()}, jcfg)
    jhf.save_hf_checkpoint(str(jdir), same, jcfg)
    for name in ("config.json", "vocab.txt", "tokenizer_config.json",
                 "preprocessor_config.json"):
        assert (jdir / name).read_bytes() == (tmp_path / name).read_bytes(), name
    ours, theirs = st.load_file(str(tmp_path / "model.safetensors")), st.load_file(
        str(jdir / "model.safetensors"))
    assert set(ours) == set(theirs)
    for k in theirs:
        assert torch.equal(ours[k].reshape(theirs[k].shape), theirs[k]), k


def test_save_hf_checkpoint_vocab_rules(tmp_path):
    cfg = dataclasses.replace(tconfigs.tiny_config(),
                              text=dataclasses.replace(tconfigs.tiny_config().text,
                                                       vocab_size=120))
    m = api.model_from_config(cfg, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hf.save_hf_checkpoint(str(tmp_path / "warned"), m, cfg)
    assert any("vocab" in str(w.message) for w in caught)
    assert (tmp_path / "warned" / "model.safetensors").is_file()
    assert not (tmp_path / "warned" / "vocab.txt").exists()
    bad = tmp_path / "bad_vocab.txt"
    bad.write_text("\n".join(f"tok{i}" for i in range(7)) + "\n", encoding="utf-8")
    with pytest.raises(ValueError, match="120"):
        hf.save_hf_checkpoint(str(tmp_path / "raised"), m, cfg, vocab_file=str(bad))
    ok = tmp_path / "vocab120.txt"
    ok.write_text("\n".join(f"tok{i}" for i in range(120)), encoding="utf-8")
    hf.save_hf_checkpoint(str(tmp_path / "ok"), m, cfg, vocab_file=str(ok))
    assert (tmp_path / "ok" / "tokenizer_config.json").is_file()
    with pytest.raises(ValueError, match="quantized"):
        hf.save_hf_checkpoint(str(tmp_path / "q"), m.quantize("int8"), cfg)


# -- .safetensors -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_bit_equal_both_ways(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(3, 5, generator=g).to(dtype),
               "a.bias": torch.randn(7, generator=g).to(dtype),
               "scalar": torch.tensor(2.5).to(dtype),
               "ids": torch.arange(4, dtype=torch.int64),
               "mask": torch.arange(6, dtype=torch.int32).reshape(2, 3),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    meta = {"format": "pt"}   # the package orders two or more keys by a hash map
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    st.save_file(tensors, ours, metadata=meta)
    save_file(tensors, theirs, metadata=meta)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    st.save_file(tensors, ours)
    save_file(tensors, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back, ref = st.load_file(theirs), load_file(theirs)
    assert set(back) == set(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype and back[k].shape == ref[k].shape, k
        assert torch.equal(back[k].reshape(-1).view(torch.uint8),
                           ref[k].reshape(-1).view(torch.uint8)), k
