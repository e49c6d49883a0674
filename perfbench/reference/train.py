"""The reference's training step: the CLIP contrastive loss over the
batch, its gradients by autograd through :mod:`perfbench.reference.model`
with the text dropout, and AdamW over fp32 parameters, from the published
fine-tuning recipe (cn_clip/training/main.py, train.py, scheduler.py):

- loss: ``(CE(s * I T^T, arange) + CE(s * T I^T, arange)) / 2`` on the
  L2-normalised features, ``s = exp(logit_scale)``;
- learning rate: linear warmup ``lr * (step + 1) / warmup``, then cosine
  decay to 0 at ``total_steps``;
- AdamW (Loshchilov and Hutter): decoupled decay ``p -= lr * wd * p``, then
  ``p -= lr * m_hat / (sqrt(v_hat) + eps)``; no decay for a parameter whose
  name holds ``bn``, ``ln``, ``bias`` or ``logit_scale``;
- ``logit_scale`` clamped to [0, ln 100] after each update.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference import model as ref_model
from perfbench.reference import precise

NO_DECAY = ("bn", "ln", "bias", "logit_scale")


def clip_loss(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor) -> torch.Tensor:
    img, txt = ref_model.normalize(img), ref_model.normalize(txt)
    logits = logit_scale.float().exp() * img @ txt.t()
    labels = torch.arange(img.shape[0], device=img.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2


def lr_at(step: int, lr: float, warmup: int, total: int) -> float:
    if step < warmup:
        return lr * (step + 1) / max(warmup, 1)
    e, es = step - warmup, max(total - warmup, 1)
    return 0.5 * (1 + math.cos(math.pi * e / es)) * lr


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], betas=(0.9, 0.999), eps=1e-8,
                 wd: float = 0.0):
        self.params, self.betas, self.eps, self.wd = params, betas, eps, wd
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            if not any(s in n for s in NO_DECAY):
                p.mul_(1 - lr * self.wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))


def _grads(params, cfg, images, ids, drop, prec, micro: int) -> tuple:
    """(loss, each leaf's gradient) of the batch's contrastive loss. With
    ``micro`` below the batch, in the two-pass order of the published
    recipe's gradient accumulation (cn_clip/training/train.py): every
    microbatch's features without a graph, the loss over all of them, then
    each microbatch encoded again and its slice of the features' gradient
    taken back: the full batch's gradient, in less memory."""
    names = list(params)
    leaves = [params[n] for n in names]
    b = images.shape[0]
    micro = min(micro or b, b)
    if micro == b:
        img = ref_model.encode_image(params, cfg, images, prec)
        txt = ref_model.encode_text(params, cfg, ids, prec, drop)
        loss = clip_loss(img, txt, params["logit_scale"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    else:
        parts = [slice(i, i + micro) for i in range(0, b, micro)]
        enc = lambda sl: (ref_model.encode_image(params, cfg, images[sl], prec),
                          ref_model.encode_text(params, cfg, ids[sl], prec,
                                                drop and drop.at(drop.sample0 + sl.start)))
        with torch.no_grad():
            feats = [enc(sl) for sl in parts]
        img = torch.cat([f[0] for f in feats]).requires_grad_()
        txt = torch.cat([f[1] for f in feats]).requires_grad_()
        loss = clip_loss(img, txt, params["logit_scale"])
        g_img, g_txt, g_scale = torch.autograd.grad(loss, [img, txt, params["logit_scale"]])
        total = [None] * len(leaves)
        for sl in parts:
            fi, ft = enc(sl)
            part = torch.autograd.grad([fi, ft], leaves, [g_img[sl], g_txt[sl]],
                                       allow_unused=True)
            total = [p if t is None else (t if p is None else t + p)
                     for t, p in zip(total, part)]
        total[names.index("logit_scale")] = g_scale
        grads = total
    return loss, {n: (torch.zeros_like(params[n]) if g is None else g)
                  for n, g in zip(names, grads)}


def run_steps(w: Dict[str, torch.Tensor], cfg: dict, batches: Sequence, drops: Sequence,
              hp: dict, prec: ref_model.Precision = ref_model.FP32, micro: int = 0) -> dict:
    """Train ``w`` (fp32 leaves, updated in place) for ``len(batches)``
    steps. ``batches[i]``: (images NHWC, ids); ``drops[i]``: the step's
    :class:`~perfbench.reference.model.TextDropout`; ``hp``: lr, wd, beta1,
    beta2, eps, warmup, total_steps; ``micro``: rows a pass (0: the whole
    batch). Returns each step's loss and the first step's gradient by
    leaf (the caller reads the parameters' change from ``w``)."""
    precise()
    params = {n: t.requires_grad_(True) for n, t in w.items()}
    opt = AdamW(params, (hp["beta1"], hp["beta2"]), hp["eps"], hp["wd"])
    losses: List[float] = []
    first: Optional[Dict[str, torch.Tensor]] = None
    for i, ((images, ids), drop) in enumerate(zip(batches, drops)):
        loss, grads = _grads(params, cfg, images, ids, drop, prec, micro)
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(grads, lr_at(i, hp["lr"], hp["warmup"], hp["total_steps"]))
        with torch.no_grad():
            params["logit_scale"].clamp_(0.0, math.log(100.0))
        losses.append(float(loss.detach()))
        del loss, grads
    for t in params.values():
        t.requires_grad_(False)
    return {"losses": losses, "first_grads": first}
