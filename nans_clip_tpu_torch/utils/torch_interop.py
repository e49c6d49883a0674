"""Reference ``.pt`` checkpoints and JAX parameter trees -> the port's state dict.

The port's ``nn.Module``s are named after the reference Chinese-CLIP
state-dict layout (``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``bert.encoder.layer.{i}.attention.self.query.weight``, ...), so a
normalized reference state dict loads with ``load_state_dict`` as it is.

* :func:`load_torch_state_dict` reads a reference ``.pt``: strips
  ``module.``, drops ``bert.pooler`` and splits the flash-attn ``Wqkv`` keys
  (counterpart of ``nans_clip_tpu/utils/torch_interop.py:37-97``).
* :func:`state_dict_from_jax_params` turns the JAX package's parameter tree,
  given as nested dicts of numpy arrays, into the same layout (counterpart
  of ``nans_clip_tpu/utils/torch_interop.py:333-411``), so tests can load
  identical weights into both packages.
"""

from __future__ import annotations

from typing import Dict

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
    """Strip ``module.``, drop ``bert.pooler``, de-fuse flash-attn ``Wqkv``
    keys, and convert every value to a float32 tensor."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if "bert.pooler" in k:
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


def state_dict_from_jax_params(params_np: dict, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays, as
    ``nans_clip_tpu.models.clip.init_clip`` lays it out) -> the port's
    state dict. ViT vision towers only; the JAX kernels are ``[in, out]``,
    torch Linear weights ``[out, in]``."""
    if cfg.is_resnet:
        raise NotImplementedError("the ResNet tower is not ported yet")
    sd: Dict[str, torch.Tensor] = {}

    def put(key, val, transpose=False):
        a = np.asarray(val, dtype=np.float32)
        sd[key] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    v = params_np["visual"]
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
