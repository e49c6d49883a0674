"""ModifiedResNet image tower, RN50 (counterpart of
``nans_clip_tpu/models/resnet.py``).

Modules, parameters and buffers are named after the reference
``ModifiedResNet`` (clip/model.py:23-168): the stem ``conv1..3`` /
``bn1..3``, the blocks ``layer{s}.{i}.conv1..3`` / ``.bn1..3`` with their
``downsample.0`` (conv) and ``downsample.1`` (BatchNorm), and ``attnpool``
(``positional_embedding``, ``q_proj``, ``k_proj``, ``v_proj``, ``c_proj``),
so a normalised reference state dict loads as it is. A BatchNorm holds
``weight``, ``bias``, ``running_mean`` and ``running_var``; the reference's
``num_batches_tracked`` is dropped when a state dict is normalised
(``utils/torch_interop.py``), as the JAX package ignores it.

The computation follows the JAX tower, with one exception: the stem's first
convolution (3x3, stride 2) pads 1 on each side, as the reference's
``nn.Conv2d(3, width // 2, 3, stride=2, padding=1)`` does, where the JAX
tower's ``SAME`` padding pads 0 before and 1 after on an even input (one
pixel's shift of every feature against the reference's). Every other 3x3
convolution is stride 1 and pads 1; a strided block runs the average pool,
then its stride-1 convolution (``bottleneck``, resnet.py:108-123).

* Images are NHWC ``[B, R, R, 3]``, as the ViT takes them; ``permute(0, 3,
  1, 2)`` makes them a channels-last NCHW tensor with no copy, and the
  convolution weights are held channels-last, so cuDNN takes its NHWC
  kernels without converting either. The convolutions, average pools and
  ReLUs are library calls: the JAX tower has no Pallas kernel here (plain
  XLA), so none is ported.
* BatchNorm is ``F.batch_norm`` on the compute dtype's activation with fp32
  weight, bias and running statistics (the weight and bias rounded to the
  compute dtype first, as ``cast_tree`` rounds the JAX parameters), its
  output in the compute dtype (``batch_norm``, resnet.py:56-78). The mode is
  an argument, never ``module.training``: ``bn_train`` normalises with the
  biased batch statistics and, with ``bn_update``, folds the batch mean and
  the unbiased variance into the running buffers in place (momentum 0.1, eps
  1e-5); the default normalises with the running statistics. Under data
  parallelism (``options.data`` > 1) a training BatchNorm normalises with
  the global microbatch's statistics, as the JAX tower's ``pmean``
  (resnet.py:56-71): each rank's fp32 E[x] and E[x^2] are averaged over the
  data group by a differentiable all-reduce (:class:`_MeanOverRanks`), the
  variance is E[x^2] - E[x]^2 and the running variance takes the unbiased
  factor of the global count, so every rank folds in the same statistics.
* The attention pool is the JAX tower's single-query attention
  (resnet.py:164-182): the query is the mean token plus its positional
  embedding, scores and softmax in fp32.

:meth:`ModifiedResNet.serving_weights` gives the inference forward's
tensors by name, running statistics included, so an exported program takes
them as inputs like the weights; :func:`serve` runs that forward from them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from nans_clip_tpu_torch.configs import ResNetConfig
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops.activations import upcast
from nans_clip_tpu_torch.parallel import mesh

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
EXPANSION = 4
# (stage, stride of its first block)
STAGES = ((1, 1), (2, 2), (3, 2), (4, 2))
STEM = ((1, 2), (2, 1), (3, 1))   # (conv index, stride)


class Conv(nn.Module):
    """A bias-free convolution's OIHW weight, stored channels-last."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k).to(
            memory_format=torch.channels_last))


class BatchNorm(nn.Module):
    """``BatchNorm2d``'s parameters and running statistics, without its
    forward (:func:`batch_norm` takes the mode as an argument)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(inplanes, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3), BatchNorm(planes)
        self.conv3 = Conv(planes, planes * EXPANSION, 1)
        self.bn3 = BatchNorm(planes * EXPANSION)
        self.downsample = None
        if stride > 1 or inplanes != planes * EXPANSION:
            self.downsample = nn.ModuleList([Conv(inplanes, planes * EXPANSION, 1),
                                             BatchNorm(planes * EXPANSION)])


class AttentionPool(nn.Module):
    def __init__(self, spacial: int, c: int, embed_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.empty(spacial * spacial + 1, c))
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(c, c) for _ in range(3))
        self.c_proj = nn.Linear(c, embed_dim)


def blocks(cfg: ResNetConfig):
    """``(stage, index, inplanes, planes, stride)`` of every block."""
    w, inplanes = cfg.width, cfg.width
    for (stage, stride), n, planes in zip(STAGES, cfg.layers, (w, 2 * w, 4 * w, 8 * w)):
        for i in range(n):
            yield stage, i, inplanes, planes, stride if i == 0 else 1
            inplanes = planes * EXPANSION


class _MeanOverRanks(torch.autograd.Function):
    """The mean over ``group`` of each rank's tensor; the backward is the
    mean of the ranks' gradients (each rank's loss term reaches every
    rank's statistics)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def _synced_batch_norm(x, w, key: str, bn_update: bool, group) -> torch.Tensor:
    """Training BatchNorm over the global microbatch (module docstring)."""
    xf = x.float()
    stats = _MeanOverRanks.apply(torch.stack([xf.mean((0, 2, 3)), xf.square().mean((0, 2, 3))]),
                                 group)
    mean, var = stats[0], stats[1] - stats[0].square()
    if bn_update:
        n = x.numel() // x.shape[1] * dist.get_world_size(group)
        with torch.no_grad():
            rm, rv = w[f"{key}.running_mean"], w[f"{key}.running_var"]
            rm.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.detach())
            rv.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var.detach() * n / max(n - 1, 1))
    view = lambda t: t.view(1, -1, 1, 1)
    y = (xf - view(mean)) * view(torch.rsqrt(var + BN_EPS)) * view(w[f"{key}.weight"]) \
        + view(w[f"{key}.bias"])
    return y.to(x.dtype)


def batch_norm(x: torch.Tensor, w: dict, key: str, bn_train: bool,
               bn_update: bool = True, group=None) -> torch.Tensor:
    """BatchNorm ``key`` of the weights ``w`` on x (module docstring);
    ``group``: the data group whose global statistics a training
    BatchNorm takes, or None for the local batch's."""
    if bn_train and group is not None:
        return _synced_batch_norm(x, w, key, bn_update, group)
    mean, var = w[f"{key}.running_mean"], w[f"{key}.running_var"]
    if bn_train and not bn_update:
        mean = var = None
    return F.batch_norm(x, mean, var, w[f"{key}.weight"], w[f"{key}.bias"], bn_train,
                        BN_MOMENTUM, BN_EPS)


def conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """A bias-free convolution padding (k - 1) / 2 on each side: the
    reference's padding, the stride-2 stem's included."""
    return F.conv2d(x, weight, stride=stride, padding=weight.shape[-1] // 2)


def conv_bn(x, w, key: str, bn: str, bn_train, bn_update, stride=1, relu=True, group=None):
    x = batch_norm(conv(x, w[f"{key}.weight"], stride), w, bn, bn_train, bn_update, group)
    return F.relu(x) if relu else x


def bottleneck(x, w, base: str, stride: int, bn_train: bool, bn_update: bool, group=None):
    out = conv_bn(x, w, f"{base}.conv1", f"{base}.bn1", bn_train, bn_update, group=group)
    out = conv_bn(out, w, f"{base}.conv2", f"{base}.bn2", bn_train, bn_update, group=group)
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = conv_bn(out, w, f"{base}.conv3", f"{base}.bn3", bn_train, bn_update, relu=False,
                  group=group)
    idn = x
    if f"{base}.downsample.0.weight" in w:
        if stride > 1:
            idn = F.avg_pool2d(idn, stride)
        idn = conv_bn(idn, w, f"{base}.downsample.0", f"{base}.downsample.1", bn_train,
                      bn_update, relu=False, group=group)
    return F.relu(out + idn)


def attention_pool(x: torch.Tensor, w: dict, heads: int) -> torch.Tensor:
    """Single-query attention pooling of x [B, C, h, w] -> [B, embed_dim]."""
    b, c = x.shape[:2]
    tokens = x.permute(0, 2, 3, 1).reshape(b, -1, c)
    tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], 1) + w[
        "attnpool.positional_embedding"].to(x.dtype)
    proj = lambda t, name: F.linear(t, w[f"attnpool.{name}.weight"], w[f"attnpool.{name}.bias"])
    dh = c // heads
    split = lambda t: t.reshape(b, -1, heads, dh).transpose(1, 2)
    q, k, v = split(proj(tokens[:, :1], "q_proj")), split(proj(tokens, "k_proj")), \
        split(proj(tokens, "v_proj"))
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
    out = torch.softmax(s, -1).to(v.dtype) @ v
    return proj(out.transpose(1, 2).reshape(b, c), "c_proj")


def forward(cfg: ResNetConfig, w: dict, images: torch.Tensor, bn_train: bool = False,
            bn_update: bool = True, group=None) -> torch.Tensor:
    """The tower on images [B, R, R, 3] NHWC (already in the compute dtype)
    from the weights ``w`` (:meth:`ModifiedResNet.weights`): [B, embed_dim].
    ``group``: the data group of a synced training BatchNorm, or None."""
    x = images.permute(0, 3, 1, 2)
    for i, stride in STEM:
        x = conv_bn(x, w, f"conv{i}", f"bn{i}", bn_train, bn_update, stride=stride, group=group)
    x = F.avg_pool2d(x, 2)
    for stage, i, _, _, stride in blocks(cfg):
        x = bottleneck(x, w, f"layer{stage}.{i}", stride, bn_train, bn_update, group)
    return attention_pool(x, w, cfg.heads)


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1, self.bn1 = Conv(3, w // 2, 3), BatchNorm(w // 2)
        self.conv2, self.bn2 = Conv(w // 2, w // 2, 3), BatchNorm(w // 2)
        self.conv3, self.bn3 = Conv(w // 2, w, 3), BatchNorm(w)
        for stage in range(1, 5):
            setattr(self, f"layer{stage}", nn.ModuleList(
                [Bottleneck(inp, planes, stride)
                 for s, _, inp, planes, stride in blocks(cfg) if s == stage]))
        self.attnpool = AttentionPool(cfg.image_resolution // 32, cfg.feature_dim, cfg.embed_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The distributions of ``nans_clip_tpu.models.resnet.init_resnet``:
        convolutions uniform in +-sqrt(1 / fan_in) (torch's default), every
        BatchNorm scale 1 but a block's ``bn3`` (0) and bias 0, the pool's
        matrices and positional embedding normal with std C^-0.5, its biases
        0; running means 0 and variances 1."""
        for name, m in self.named_modules():
            if isinstance(m, Conv):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(0.0 if name.endswith(".bn3") else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        std = self.cfg.feature_dim ** -0.5
        ap = self.attnpool
        ap.positional_embedding.normal_(0.0, std, generator=generator)
        for lin in (ap.q_proj, ap.k_proj, ap.v_proj, ap.c_proj):
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.zero_()

    def weights(self, options: ModelOptions) -> dict:
        """Every tensor of the forward by name, in the layout it reads:
        convolution weights, the pool's and its positional embedding in the
        compute dtype; BatchNorm weights and biases rounded to it and read in
        fp32; the running statistics, fp32, are the buffers themselves (a
        training forward updates them in place)."""
        cast = options.cast
        out = {}
        for name, m in self.named_modules():
            prefix = f"{name}." if name else ""
            for key, t in m.named_parameters(recurse=False):
                out[prefix + key] = upcast(cast(t)) if isinstance(m, BatchNorm) else cast(t)
            for key, t in m.named_buffers(recurse=False):
                out[prefix + key] = t
        return out

    def forward(self, images: torch.Tensor, options: ModelOptions = ModelOptions(),
                bn_train: bool = False, bn_update: bool = True) -> torch.Tensor:
        """images: [B, R, R, 3] NHWC. Returns [B, embed_dim]. ``bn_train``:
        batch statistics (and, with ``bn_update``, the running ones
        updated), over the global microbatch where ``options.data`` > 1;
        else the running statistics."""
        group = None
        if bn_train and options.data > 1:
            group = mesh.check_grid(options.tp, options.data, options.pp).data_group
        w = self.weights(options)
        images = images.to(options.dtype or self.attnpool.c_proj.weight.dtype)
        return forward(self.cfg, w, images, bn_train, bn_update, group)

    def serving_weights(self, options: ModelOptions) -> dict:
        """The inputs of :func:`serve`: :meth:`weights`, the running
        statistics among them."""
        return self.weights(options)


def serve(cfg: ResNetConfig, w: dict, images: torch.Tensor,
          options: Optional[ModelOptions] = None) -> torch.Tensor:
    """The inference forward of :meth:`ModifiedResNet.forward` (running
    statistics) from its :meth:`~ModifiedResNet.serving_weights` ``w``.
    images: [B, R, R, 3] NHWC; returns [B, embed_dim]."""
    del options
    return forward(cfg, w, images.to(w["attnpool.c_proj.weight"].dtype))
