"""Reference ``.pt`` checkpoints and JAX parameter trees -> the port's state dict.

The port's ``nn.Module``s are named after the reference Chinese-CLIP
state-dict layout (``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``bert.encoder.layer.{i}.attention.self.query.weight``, ...), so a
normalized reference state dict loads with ``load_state_dict`` as it is.

* :func:`load_torch_state_dict` reads a reference ``.pt``: translates an
  HF ``ChineseCLIPModel`` dict (``utils/hf_interop.py``), strips
  ``module.``, drops ``bert.pooler`` and the BatchNorms' ``num_batches_tracked``
  (the port's BatchNorms count nothing, as the JAX package reads none) and
  splits the flash-attn ``Wqkv`` keys (counterpart of
  ``nans_clip_tpu/utils/torch_interop.py:37-97``), so a reference ``.pt``, an
  HF state dict and a JAX export all load strictly.
* :func:`resize_pos_embed` resizes a ViT's positional embedding to another
  grid (bicubic, ``align_corners=True``, the class row kept; reference
  clip/model.py:551-582), and :func:`fit_pos_embed` applies it wherever a
  state dict enters a model of another resolution.
* :func:`state_dict_from_jax_params` turns the JAX package's parameter tree,
  given as nested dicts of numpy arrays, and a ResNet tower's
  ``batch_stats`` into the same layout (counterpart of
  ``nans_clip_tpu/utils/torch_interop.py:333-445``), so tests can load
  identical weights into both packages.
* :func:`lora_from_jax` turns the JAX package's LoRA adapter tree into the
  port's (``models/lora.py``).
* :func:`merge_pretrained` loads the towers of separate CLIP and BERT state
  dicts into a module, as the training CLI's ``--clip-weight-path`` and
  ``--bert-weight-path`` and ``api.load`` ask.

Tensor parallelism needs nothing more: every rank of a model group loads
the same full state dict (from a ``.pt`` or ``state_dict_from_jax_params``)
and the TP sub-blocks slice each rank's heads and columns from it on each
forward (``parallel/mesh.py``), where the JAX package shards its tree over
the mesh instead.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nans_clip_tpu_torch.configs import CLIPConfig


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference-layout checkpoint into {key: float32 tensor}."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return normalize_state_dict(obj)


def normalize_state_dict(sd: dict) -> Dict[str, torch.Tensor]:
    """Translate an HF ``ChineseCLIPModel`` dict first, then strip
    ``module.``, drop ``bert.pooler`` and ``num_batches_tracked``, de-fuse
    flash-attn ``Wqkv`` keys, and convert every value to a float32 tensor."""
    from nans_clip_tpu_torch.utils.hf_interop import hf_to_reference_state_dict, is_hf_layout

    if is_hf_layout(sd):
        sd = hf_to_reference_state_dict(sd)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if "bert.pooler" in k or k.endswith("num_batches_tracked"):
            continue
        out[k] = torch.as_tensor(v).detach().to("cpu", torch.float32)

    # visual tower: flash-attn fused layout -> torch MHA layout
    for k in list(out):
        if "attn.Wqkv.weight" in k:
            out[k.replace("attn.Wqkv.weight", "attn.in_proj_weight")] = out.pop(k)
        elif "attn.Wqkv.bias" in k:
            out[k.replace("attn.Wqkv.bias", "attn.in_proj_bias")] = out.pop(k)

    # bert tower: flash-attn fused layout -> separate q/k/v + output.dense
    i = 0
    while f"bert.encoder.layer.{i}.attention.self.Wqkv.weight" in out:
        base = f"bert.encoder.layer.{i}.attention"
        wq, wk, wv = out.pop(f"{base}.self.Wqkv.weight").chunk(3, dim=0)
        bq, bk, bv = out.pop(f"{base}.self.Wqkv.bias").chunk(3, dim=0)
        out[f"{base}.self.query.weight"], out[f"{base}.self.query.bias"] = wq, bq
        out[f"{base}.self.key.weight"], out[f"{base}.self.key.bias"] = wk, bk
        out[f"{base}.self.value.weight"], out[f"{base}.self.value.bias"] = wv, bv
        out[f"{base}.output.dense.weight"] = out.pop(f"{base}.self.out_proj.weight")
        out[f"{base}.output.dense.bias"] = out.pop(f"{base}.self.out_proj.bias")
        i += 1
    return out


def resize_grid_bicubic(grid: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] -> [H', W', C], torch's bicubic ``align_corners=True`` in
    float64 (counterpart of ``nans_clip_tpu/utils/torch_interop.py:104-133``)."""
    x = torch.from_numpy(np.asarray(grid, np.float64)).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(x, size=tuple(new_hw), mode="bicubic",
                                          align_corners=True)
    return out[0].permute(1, 2, 0).numpy().astype(grid.dtype)


def resize_pos_embed(pos: np.ndarray, new_grid: int, extra_tokens: int = 1) -> np.ndarray:
    """[g0 * g0 + extra, W] -> [new_grid ** 2 + extra, W], the class row(s)
    kept (reference clip/model.py:551-582)."""
    if pos.shape[0] == new_grid * new_grid + extra_tokens:
        return pos
    tok, img = pos[:extra_tokens], pos[extra_tokens:]
    g0 = math.isqrt(img.shape[0])
    grid = resize_grid_bicubic(img.reshape(g0, g0, -1), (new_grid, new_grid))
    return np.concatenate([tok, grid.reshape(new_grid * new_grid, -1)], axis=0)


def fit_pos_embed(sd: dict, module: torch.nn.Module) -> dict:
    """``sd`` with its ViT positional embedding resized to ``module``'s grid
    when the two differ (a 224 px checkpoint in a 336 px model), as the JAX
    loader does (``nans_clip_tpu/utils/torch_interop.py:159-163``); ``sd``
    itself otherwise. A ResNet's attention-pool embedding is left as it is,
    as in JAX."""
    key = "visual.positional_embedding"
    own = getattr(getattr(module, "visual", None), "positional_embedding", None)
    if key not in sd or own is None or sd[key].shape[0] == own.shape[0]:
        return sd
    grid = math.isqrt(own.shape[0] - 1)
    return {**sd, key: torch.from_numpy(resize_pos_embed(sd[key].numpy(), grid))}


def state_dict_from_jax_params(params_np: dict, cfg: CLIPConfig,
                               batch_stats_np: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays, as
    ``nans_clip_tpu.models.clip.init_clip`` lays it out) -> the port's
    state dict; a ResNet tower's running statistics from ``batch_stats_np``
    (mean 0 and variance 1 where it has none, as the JAX export writes
    them). The JAX kernels are ``[in, out]`` (HWIO for a convolution), torch
    weights ``[out, in]`` (OIHW)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, val, transpose=False):
        a = np.asarray(val, dtype=np.float32)
        sd[key] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    v = params_np["visual"]
    if cfg.is_resnet:
        _resnet_to_sd(v, batch_stats_np or {}, put)
    else:
        _vit_to_sd(v, put)

    e = params_np["bert"]["embeddings"]
    put("bert.embeddings.word_embeddings.weight", e["word"])
    put("bert.embeddings.position_embeddings.weight", e["position"])
    put("bert.embeddings.token_type_embeddings.weight", e["token_type"])
    put("bert.embeddings.LayerNorm.weight", e["ln"]["scale"])
    put("bert.embeddings.LayerNorm.bias", e["ln"]["bias"])
    enc = params_np["bert"]["encoder"]
    h = enc["attn"]["wqkv"].shape[1]
    for i in range(enc["attn"]["wqkv"].shape[0]):
        base = f"bert.encoder.layer.{i}"
        wqkv, bqkv = enc["attn"]["wqkv"][i], enc["attn"]["bqkv"][i]
        for j, name in enumerate(("query", "key", "value")):
            put(f"{base}.attention.self.{name}.weight", wqkv[:, j * h:(j + 1) * h], transpose=True)
            put(f"{base}.attention.self.{name}.bias", bqkv[j * h:(j + 1) * h])
        put(f"{base}.attention.output.dense.weight", enc["attn"]["wo"][i], transpose=True)
        put(f"{base}.attention.output.dense.bias", enc["attn"]["bo"][i])
        put(f"{base}.attention.output.LayerNorm.weight", enc["attn_ln"]["scale"][i])
        put(f"{base}.attention.output.LayerNorm.bias", enc["attn_ln"]["bias"][i])
        put(f"{base}.intermediate.dense.weight", enc["mlp"]["w1"][i], transpose=True)
        put(f"{base}.intermediate.dense.bias", enc["mlp"]["b1"][i])
        put(f"{base}.output.dense.weight", enc["mlp"]["w2"][i], transpose=True)
        put(f"{base}.output.dense.bias", enc["mlp"]["b2"][i])
        put(f"{base}.output.LayerNorm.weight", enc["mlp_ln"]["scale"][i])
        put(f"{base}.output.LayerNorm.bias", enc["mlp_ln"]["bias"][i])

    put("text_projection", params_np["text_projection"])
    put("logit_scale", np.asarray(params_np["logit_scale"]).reshape(()))
    return sd


def _vit_to_sd(v: dict, put) -> None:
    put("visual.conv1.weight", np.transpose(v["conv1"]["kernel"], (3, 2, 0, 1)))
    put("visual.class_embedding", v["class_embedding"])
    put("visual.positional_embedding", v["positional_embedding"])
    put("visual.ln_pre.weight", v["ln_pre"]["scale"])
    put("visual.ln_pre.bias", v["ln_pre"]["bias"])
    t = v["transformer"]
    for i in range(t["ln_1"]["scale"].shape[0]):
        r = f"visual.transformer.resblocks.{i}"
        put(f"{r}.ln_1.weight", t["ln_1"]["scale"][i])
        put(f"{r}.ln_1.bias", t["ln_1"]["bias"][i])
        put(f"{r}.attn.in_proj_weight", t["attn"]["wqkv"][i], transpose=True)
        put(f"{r}.attn.in_proj_bias", t["attn"]["bqkv"][i])
        put(f"{r}.attn.out_proj.weight", t["attn"]["wo"][i], transpose=True)
        put(f"{r}.attn.out_proj.bias", t["attn"]["bo"][i])
        put(f"{r}.ln_2.weight", t["ln_2"]["scale"][i])
        put(f"{r}.ln_2.bias", t["ln_2"]["bias"][i])
        put(f"{r}.mlp.c_fc.weight", t["mlp"]["w1"][i], transpose=True)
        put(f"{r}.mlp.c_fc.bias", t["mlp"]["b1"][i])
        put(f"{r}.mlp.c_proj.weight", t["mlp"]["w2"][i], transpose=True)
        put(f"{r}.mlp.c_proj.bias", t["mlp"]["b2"][i])
    put("visual.ln_post.weight", v["ln_post"]["scale"])
    put("visual.ln_post.bias", v["ln_post"]["bias"])
    put("visual.proj", v["proj"])


def _resnet_to_sd(v: dict, stats: dict, put) -> None:
    """The JAX ResNet tree and its statistics (``_resnet_to_sd``,
    nans_clip_tpu/utils/torch_interop.py:414-445)."""
    def conv(key, p):
        put(f"{key}.weight", np.transpose(p["kernel"], (3, 2, 0, 1)))

    def bn(key, p, s):
        if not s:
            s = {"mean": np.zeros_like(p["bias"]), "var": np.ones_like(p["bias"])}
        put(f"{key}.weight", p["scale"])
        put(f"{key}.bias", p["bias"])
        put(f"{key}.running_mean", s["mean"])
        put(f"{key}.running_var", s["var"])

    for i in (1, 2, 3):
        conv(f"visual.conv{i}", v[f"conv{i}"])
        bn(f"visual.bn{i}", v[f"bn{i}"], stats.get(f"bn{i}", {}))
    for stage in range(1, 5):
        blocks = v[f"layer{stage}"]
        for i, (bp, bs) in enumerate(zip(blocks, stats.get(f"layer{stage}", [{}] * len(blocks)))):
            base = f"visual.layer{stage}.{i}"
            for j in (1, 2, 3):
                conv(f"{base}.conv{j}", bp[f"conv{j}"])
                bn(f"{base}.bn{j}", bp[f"bn{j}"], bs.get(f"bn{j}", {}))
            if "downsample" in bp:
                conv(f"{base}.downsample.0", bp["downsample"]["conv"])
                bn(f"{base}.downsample.1", bp["downsample"]["bn"], bs.get("downsample_bn", {}))
    ap = v["attnpool"]
    put("visual.attnpool.positional_embedding", ap["positional_embedding"])
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj")):
        put(f"visual.attnpool.{theirs}.weight", ap[ours]["kernel"], transpose=True)
        put(f"visual.attnpool.{theirs}.bias", ap[ours]["bias"])


def lora_from_jax(adapters_np: dict, device="cpu") -> dict:
    """The JAX adapter tree (``nans_clip_tpu/models/lora.py``: nested dicts
    of numpy arrays, ``[L, r, W]`` / ``[L, W, r]`` and ``[L, 2, r, H]`` /
    ``[L, 2, H, r]`` stacks) as the port's: the same tree and shapes, fp32
    leaves on ``device`` that require gradients. The port's ``merge_lora``
    applies ``B A`` in ``[out, in]``, the transpose of the JAX delta."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(device).requires_grad_()
    return conv(adapters_np)


def merge_pretrained(module: torch.nn.Module, clip_sd: Optional[dict] = None,
                     bert_sd: Optional[dict] = None) -> int:
    """Initialise the towers from separate CLIP and Chinese-BERT state dicts
    (normalised, as :func:`load_torch_state_dict` returns them; reference
    restore_model, clip/model.py:468-490; the JAX ``merge_pretrained``'s key
    filters): ``visual.*`` and ``logit_scale`` from the first, ``bert.*``
    but the pooler from the second; the rest (``text_projection``) keeps
    its init. A positional embedding of another grid is resized to the
    module's (:func:`fit_pos_embed`). Returns the number of tensors loaded."""
    merged: Dict[str, torch.Tensor] = {}
    if clip_sd:
        merged.update({k: v for k, v in clip_sd.items()
                       if k.startswith("visual") or k == "logit_scale"})
    if bert_sd:
        merged.update({k: v for k, v in bert_sd.items()
                       if k.startswith("bert") and "bert.pooler" not in k})
    merged = fit_pos_embed(merged, module)
    own = module.state_dict()
    unknown = sorted(set(merged) - set(own))
    if unknown:
        raise KeyError(f"keys not in the model: {unknown[:5]}")
    with torch.no_grad():
        for k, v in merged.items():
            own[k].copy_(v.reshape(own[k].shape))
    return len(merged)
