"""HuggingFace ``ChineseCLIPModel`` checkpoints <-> the port (counterpart of
``nans_clip_tpu/utils/hf_interop.py``).

The reference publishes its weights in two formats: its own ``.pt`` state
dicts (``utils/torch_interop.py``) and the ``transformers`` port
(``OFA-Sys/chinese-clip-*`` on the Hub, ``ChineseCLIPModel``). This module
maps the second onto the first, in both directions, by key names, so every
loader of a reference state dict takes an HF one too:

* the HF vision tower is the CLIP pre-LN ViT (``pre_layrnorm`` [sic],
  quick-GELU, ``post_layernorm`` on the class row, a bias-free
  ``visual_projection``), the reference's ``VisualTransformer``; its
  separate ``q/k/v_proj`` are stacked into ``in_proj_*`` (order q, k, v);
* the HF text tower is the reference's Chinese BERT, ``text_model.*`` =
  ``bert.*``, its pooler dropped;
* HF stores the projections as ``nn.Linear`` weights ``[embed, width]``,
  the reference as matrices ``[width, embed]``.

There is no HF ResNet variant, so only ViT towers map. Snapshots are read
and written with ``utils/safetensors_io.py`` (``model.safetensors``) or
``torch.load`` (``pytorch_model.bin``); nothing is downloaded.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Dict, Optional, Tuple

import torch

from nans_clip_tpu_torch.configs import CLIPConfig, TextConfig, VisionConfig

# buffers and heads that carry no weight the port uses
_DROP = re.compile(r"(\.position_ids$|^text_model\.pooler\.|\.num_batches_tracked$)")

# straight renames (vision side); q/k/v are stacked separately
_VISION_RULES = [
    (re.compile(r"^vision_model\.embeddings\.class_embedding$"), "visual.class_embedding"),
    (re.compile(r"^vision_model\.embeddings\.patch_embedding\.weight$"), "visual.conv1.weight"),
    (re.compile(r"^vision_model\.embeddings\.position_embedding\.weight$"),
     "visual.positional_embedding"),
    (re.compile(r"^vision_model\.pre_layrnorm\.(weight|bias)$"), r"visual.ln_pre.\1"),
    (re.compile(r"^vision_model\.post_layernorm\.(weight|bias)$"), r"visual.ln_post.\1"),
    (re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.(weight|bias)$"),
     r"visual.transformer.resblocks.\1.ln_1.\2"),
    (re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.(weight|bias)$"),
     r"visual.transformer.resblocks.\1.ln_2.\2"),
    (re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.(weight|bias)$"),
     r"visual.transformer.resblocks.\1.attn.out_proj.\2"),
    (re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.(weight|bias)$"),
     r"visual.transformer.resblocks.\1.mlp.c_fc.\2"),
    (re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.(weight|bias)$"),
     r"visual.transformer.resblocks.\1.mlp.c_proj.\2"),
]

_QKV = re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.([qkv])_proj\.(weight|bias)$")


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32)


def is_hf_layout(sd: dict) -> bool:
    """True when the checkpoint is (mostly) in the HF ``ChineseCLIPModel``
    layout: a majority vote, so that one stray ``vision_model.*`` key in a
    reference dict does not turn the whole dict over."""
    if not sd:
        return False
    hf = sum(k.startswith(("vision_model.", "text_model."))
             or k in ("visual_projection.weight", "text_projection.weight") for k in sd)
    ref = sum(k.startswith(("visual.", "bert.", "module.")) for k in sd)
    return hf > max(ref, len(sd) // 2)


def hf_to_reference_state_dict(sd: dict) -> Dict[str, torch.Tensor]:
    """HF ``ChineseCLIPModel.state_dict()`` -> the reference layout
    (``visual.* / bert.* / text_projection / logit_scale``), fp32 tensors.
    Raises KeyError on a weight key it does not map, so that a checkpoint of
    another model fails loudly instead of dropping tensors."""
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[Tuple[int, str], Dict[str, torch.Tensor]] = {}
    unmapped = []
    for k, v in sd.items():
        if _DROP.search(k):
            continue
        m = _QKV.match(k)
        if m:
            qkv.setdefault((int(m.group(1)), m.group(3)), {})[m.group(2)] = _f32(v)
            continue
        if k.startswith("text_model."):
            out["bert." + k[len("text_model."):]] = _f32(v)
        elif k == "visual_projection.weight":
            out["visual.proj"] = _f32(v).T.contiguous()
        elif k == "text_projection.weight":
            out["text_projection"] = _f32(v).T.contiguous()
        elif k == "logit_scale":
            out["logit_scale"] = _f32(v)
        else:
            for pat, repl in _VISION_RULES:
                if pat.match(k):
                    out[pat.sub(repl, k)] = _f32(v)
                    break
            else:
                unmapped.append(k)
    if unmapped:
        raise KeyError(f"unmapped HF checkpoint keys: {sorted(unmapped)}")
    for (layer, kind), parts in qkv.items():
        if set(parts) != {"q", "k", "v"}:
            raise KeyError(f"incomplete q/k/v set for vision layer {layer}: "
                           f"{sorted(parts)} ({kind})")
        name = "in_proj_weight" if kind == "weight" else "in_proj_bias"
        out[f"visual.transformer.resblocks.{layer}.attn.{name}"] = torch.cat(
            [parts["q"], parts["k"], parts["v"]], dim=0)
    return out


def reference_to_hf_state_dict(sd: dict) -> Dict[str, torch.Tensor]:
    """The reference layout (as ``load_torch_state_dict`` returns it, ViT
    towers) -> HF ``ChineseCLIPModel`` key names, fp32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        v = _f32(v)
        if k.startswith("bert."):
            out["text_model." + k[len("bert."):]] = v
        elif k == "visual.proj":
            out["visual_projection.weight"] = v.T.contiguous()
        elif k == "text_projection":
            out["text_projection.weight"] = v.T.contiguous()
        elif k == "logit_scale":
            out["logit_scale"] = v
        elif k == "visual.class_embedding":
            out["vision_model.embeddings.class_embedding"] = v
        elif k == "visual.conv1.weight":
            out["vision_model.embeddings.patch_embedding.weight"] = v
        elif k == "visual.positional_embedding":
            out["vision_model.embeddings.position_embedding.weight"] = v
        elif k.startswith("visual.ln_pre."):
            out["vision_model.pre_layrnorm." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("visual.ln_post."):
            out["vision_model.post_layernorm." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("visual.transformer.resblocks."):
            layer, sub = k[len("visual.transformer.resblocks."):].split(".", 1)
            base = f"vision_model.encoder.layers.{layer}"
            if sub in ("attn.in_proj_weight", "attn.in_proj_bias"):
                kind = "weight" if sub.endswith("weight") else "bias"
                for name, part in zip("qkv", v.chunk(3, dim=0)):
                    out[f"{base}.self_attn.{name}_proj.{kind}"] = part.contiguous()
            else:
                sub = (sub.replace("ln_1.", "layer_norm1.").replace("ln_2.", "layer_norm2.")
                       .replace("attn.out_proj.", "self_attn.out_proj.")
                       .replace("mlp.c_fc.", "mlp.fc1.").replace("mlp.c_proj.", "mlp.fc2."))
                out[f"{base}.{sub}"] = v
        else:
            raise KeyError(f"cannot map reference key to HF layout: {k}")
    return out


def config_from_hf(hf_config: dict) -> CLIPConfig:
    """A :class:`CLIPConfig` from a ``ChineseCLIPConfig`` dict (config.json).
    Refuses what the towers cannot represent (a vision activation other than
    quick-GELU, an MLP ratio other than 4) instead of loading it wrong."""
    v, t = hf_config["vision_config"], hf_config["text_config"]
    act = v.get("hidden_act", "quick_gelu")
    if act != "quick_gelu":
        raise ValueError(f"vision hidden_act={act!r}: the CLIP ViT uses "
                         "quick_gelu (reference clip/model.py:171-178)")
    if v.get("intermediate_size", 4 * v["hidden_size"]) != 4 * v["hidden_size"]:
        raise ValueError("vision MLP ratio != 4 is not a CLIP ViT")
    embed_dim = hf_config.get("projection_dim", v.get("projection_dim", 512))
    vision = VisionConfig(
        embed_dim=embed_dim, image_resolution=v["image_size"], layers=v["num_hidden_layers"],
        width=v["hidden_size"], patch_size=v["patch_size"],
        head_width=v["hidden_size"] // v["num_attention_heads"])
    text = TextConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        num_hidden_layers=t["num_hidden_layers"], num_attention_heads=t["num_attention_heads"],
        intermediate_size=t["intermediate_size"], hidden_act=t.get("hidden_act", "gelu"),
        hidden_dropout_prob=t.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=t.get("attention_probs_dropout_prob", 0.1),
        max_position_embeddings=t.get("max_position_embeddings", 512),
        type_vocab_size=t.get("type_vocab_size", 2),
        initializer_range=t.get("initializer_range", 0.02),
        layer_norm_eps=t.get("layer_norm_eps", 1e-12))
    return CLIPConfig(embed_dim=embed_dim, vision=vision, text=text,
                      name=hf_config.get("_name_or_path", "hf"))


def config_to_hf(cfg: CLIPConfig) -> dict:
    """:class:`CLIPConfig` -> a ``ChineseCLIPConfig``-shaped dict."""
    if cfg.is_resnet:
        raise ValueError("HF ChineseCLIP has no ResNet vision tower")
    v, t = cfg.vision, cfg.text
    return {
        "model_type": "chinese_clip",
        "projection_dim": cfg.embed_dim,
        "logit_scale_init_value": 2.6592,
        "vision_config": {
            "model_type": "chinese_clip_vision_model",
            "hidden_size": v.width,
            "intermediate_size": 4 * v.width,
            "num_hidden_layers": v.layers,
            "num_attention_heads": v.heads,
            "image_size": v.image_resolution,
            "patch_size": v.patch_size,
            "hidden_act": "quick_gelu",
            "projection_dim": cfg.embed_dim,
        },
        "text_config": {
            "model_type": "chinese_clip_text_model",
            "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "intermediate_size": t.intermediate_size,
            "hidden_act": t.hidden_act,
            "hidden_dropout_prob": t.hidden_dropout_prob,
            "attention_probs_dropout_prob": t.attention_probs_dropout_prob,
            "max_position_embeddings": t.max_position_embeddings,
            "type_vocab_size": t.type_vocab_size,
            "initializer_range": t.initializer_range,
            "layer_norm_eps": t.layer_norm_eps,
        },
    }


def load_hf_checkpoint(path: str, cfg: Optional[CLIPConfig] = None
                       ) -> Tuple[Dict[str, torch.Tensor], CLIPConfig]:
    """An HF ``ChineseCLIPModel`` snapshot directory (or one weights file)
    -> (reference-layout fp32 state dict, cfg). A directory is read as
    ``from_pretrained`` reads it: ``config.json`` for the architecture
    (unless ``cfg`` is given), ``model.safetensors``, else
    ``pytorch_model.bin``, for the weights."""
    from nans_clip_tpu_torch.utils.safetensors_io import load_file

    weights_file = path
    if os.path.isdir(path):
        if cfg is None:
            with open(os.path.join(path, "config.json")) as f:
                cfg = config_from_hf(json.load(f))
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                weights_file = cand
                break
        else:
            raise FileNotFoundError(f"no weights file under {path}")
    if cfg is None:
        raise ValueError("cfg is required when loading a bare weights file")
    if weights_file.endswith(".safetensors"):
        sd = load_file(weights_file)
    else:
        sd = torch.load(weights_file, map_location="cpu", weights_only=True)
    return hf_to_reference_state_dict(sd), cfg


def _reference_state_dict(weights) -> Dict[str, torch.Tensor]:
    """A module (``CLIP`` or a ``CLIPModel``'s) or a state dict -> the
    reference-layout fp32 state dict that :func:`reference_to_hf_state_dict`
    maps."""
    module = getattr(weights, "module", weights)
    if isinstance(module, torch.nn.Module):
        from nans_clip_tpu_torch.utils.quantize import quantize_mode
        if quantize_mode(module):
            raise ValueError("the module is int8-quantized for serving; checkpoints are "
                             "exported from the original weights")
        return module.state_dict()
    return weights


def save_hf_checkpoint(path: str, weights, cfg: CLIPConfig,
                       vocab_file: Optional[str] = None, context_length: int = 52) -> None:
    """Write a ``from_pretrained``-loadable directory: ``config.json`` and
    ``model.safetensors`` (fp32) in the ``ChineseCLIPModel`` layout.
    ``weights``: a ``CLIPModel``, its ``CLIP`` module or a reference-layout
    state dict.

    When the text tower's vocab size equals the vocab file's entry count
    (the bundled Chinese-BERT vocab by default), the processor side is
    written too (``vocab.txt``, ``tokenizer_config.json``,
    ``preprocessor_config.json``: square bicubic resize, the OpenAI mean and
    std), so that ``ChineseCLIPProcessor.from_pretrained`` loads the
    directory. A mismatch warns and writes the model alone for the default
    vocab, and raises for an explicit ``vocab_file``."""
    from nans_clip_tpu_torch.tokenizer import DEFAULT_VOCAB
    from nans_clip_tpu_torch.utils.safetensors_io import save_file
    from nans_clip_tpu_torch.utils.transform import OPENAI_MEAN, OPENAI_STD

    hf_config = config_to_hf(cfg)   # raises on a ResNet before any file is written
    sd = reference_to_hf_state_dict(_reference_state_dict(weights))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    save_file(sd, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})

    explicit_vocab = vocab_file is not None
    vocab_file = vocab_file or DEFAULT_VOCAB
    with open(vocab_file, encoding="utf-8") as f:
        vocab = f.read()
    # not splitlines(): the vocab holds a U+2028 entry that it would split
    n_lines = len(vocab.split("\n")) - (1 if vocab.endswith("\n") else 0)
    if n_lines != cfg.text.vocab_size:
        msg = (f"vocab file {vocab_file} has {n_lines} entries but the model "
               f"was built with vocab_size={cfg.text.vocab_size}")
        if explicit_vocab:
            raise ValueError(msg)
        warnings.warn(msg + " — exporting the model only (no vocab.txt/tokenizer_config/"
                      "preprocessor_config; the dir will not be ChineseCLIPProcessor-loadable)",
                      stacklevel=2)
        return
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write(vocab)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True,
                   "model_max_length": context_length}, f, indent=2)
    r = cfg.vision.image_resolution
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"image_processor_type": "ChineseCLIPImageProcessor",
                   "do_resize": True, "size": {"height": r, "width": r},
                   "resample": 3, "do_center_crop": False,
                   "do_rescale": True, "rescale_factor": 1 / 255,
                   "do_normalize": True, "image_mean": list(OPENAI_MEAN),
                   "image_std": list(OPENAI_STD),
                   "do_convert_rgb": True}, f, indent=2)
