"""Training CLI flags (counterpart of ``nans_clip_tpu/training/params.py``):
the JAX CLI's flags, defaults and per-architecture defaults, reference
training/params.py:16-236.

What differs:

* ``--platform cpu|cuda`` (default ``cuda``): the card unless the caller
  asks for the CPU; without a card the default raises;
* ``--precision``: ``fp32`` keeps fp32 compute, every other value is bf16
  (``models.common.compute_dtype_for``);
* the JAX CLI's no-op flags (``--use-bn-sync``, ``--use-flash-attention``,
  ``--gather-with-grad``, ``--skip-aggregate``) are accepted and ignored
  with a warning (``training/main.py``), as there;
* ``--distributed`` (or a launcher's rendezvous in the environment) runs
  one process a rank (``parallel/distributed.py``); ``--dist-timeout``
  bounds each collective, so that a rank whose peer failed fails too;
  ``--tp`` and ``--pp`` take their own ranks of the grid.
"""

from __future__ import annotations

import argparse


def get_default_params(model_name: str) -> dict:
    # Per-arch defaults from the CLIP paper (reference params.py:4-13).
    if model_name in ("RN50", "RN101", "RN50x4"):
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}
    if model_name in ("ViT-B-32", "ViT-B-16", "ViT-H-14"):
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    if model_name in ("ViT-L-14", "ViT-L-14-336"):
        return {"lr": 4.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {}


def parse_args(argv=None):
    p = argparse.ArgumentParser("nans_clip_tpu_torch trainer")
    # data
    p.add_argument("--train-data", default=None, help="npack dataset dir (train split)")
    p.add_argument("--val-data", default=None, help="npack dataset dir (val split)")
    p.add_argument("--num-workers", type=int, default=8, help="decode threads")
    p.add_argument("--valid-num-workers", type=int, default=8)
    # logging / ckpt
    p.add_argument("--logs", default="./logs/")
    p.add_argument("--name", default="train_clip")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--report-training-batch-acc", action="store_true", default=True)
    p.add_argument("--save-epoch-frequency", type=int, default=1)
    p.add_argument("--save-step-frequency", type=int, default=-1)
    p.add_argument("--resume", default=None)
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--reset-data-offset", action="store_true")
    p.add_argument("--save-torch-format", action="store_true",
                   help="also write reference-layout .pt checkpoints")
    # batches / schedule
    p.add_argument("--batch-size", type=int, default=64, help="per-device batch size")
    p.add_argument("--valid-batch-size", type=int, default=64)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--max-epochs", type=int, default=10)
    p.add_argument("--valid-step-interval", type=int, default=None)
    p.add_argument("--valid-epoch-interval", type=int, default=1)
    p.add_argument("--context-length", type=int, default=52)
    # optimizer
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--beta2", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--wd", type=float, default=0.001)
    p.add_argument("--warmup", type=int, default=500)
    p.add_argument("--skip-scheduler", action="store_true",
                   help="constant lr after warmup (no cosine decay). The "
                        "reference parses but never applies this flag; here "
                        "it does what the help text promises")
    # model
    p.add_argument("--vision-model", default="ViT-B-16",
                   choices=["ViT-B-32", "ViT-B-16", "ViT-L-14", "ViT-L-14-336",
                            "ViT-H-14", "RN50"])
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese",
                   choices=["RoBERTa-wwm-ext-base-chinese",
                            "RoBERTa-wwm-ext-large-chinese", "RBT3-chinese"])
    p.add_argument("--clip-weight-path", default=None)
    p.add_argument("--bert-weight-path", default=None)
    p.add_argument("--precision", choices=["amp", "fp16", "fp32", "bf16"],
                   default="bf16", help="amp/fp16 map to bf16")
    p.add_argument("--mask-ratio", type=float, default=0.0, help="FLIP masking")
    p.add_argument("--freeze-vision", action="store_true")
    p.add_argument("--grad-checkpointing", action="store_true",
                   help="recompute each transformer layer's activations in the backward")
    p.add_argument("--use-augment", action="store_true")
    p.add_argument("--exact-decode", action="store_true",
                   help="decode training images with the PIL-bit-exact "
                        "bicubic path (the reference's non-augment "
                        "transform pixels, training/data.py:85-90) "
                        "instead of the DCT-scaled bilinear fast decode")
    p.add_argument("--use-bn-sync", action="store_true", help="no-op")
    p.add_argument("--use-flash-attention", action="store_true",
                   help="no-op: the fused kernels are the default")
    p.add_argument("--attn-impl", choices=["auto", "pallas", "xla", "fused"],
                   default="auto")
    p.add_argument("--accum-freq", type=int, default=1)
    p.add_argument("--gather-with-grad", action="store_true", help="no-op (always)")
    p.add_argument("--skip-aggregate", action="store_true", help="no-op")
    p.add_argument("--grad-norm-clip", type=float, default=None)
    p.add_argument("--adam-state-dtype", default=None,
                   choices=["bfloat16", "float32"],
                   help="store Adam moments in this dtype; bfloat16 halves "
                        "the optimizer's memory")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    # parallelism: the data x tp x pipe grid of the ranks (--tp and --pp exclusive)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: the ranks of a model group; the data axis is "
                        "the world size / tp")
    p.add_argument("--fsdp", action="store_true",
                   help="store the parameters and Adam moments sharded over the data axis")
    p.add_argument("--fsdp-min-size", type=int, default=None,
                   help="leaves smaller than this stay replicated under --fsdp (default 65536)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per group: K single steps on K "
                        "preprocessed batches held on the device; the "
                        "trajectory is identical to 1. Log/valid/save "
                        "cadences round up to the next group boundary")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages: the ranks of a pipe group, each storing its own "
                        "layers of each transformer tower (exclusive with --tp)")
    p.add_argument("--pp-microbatches", type=int, default=0,
                   help="GPipe microbatches of a rank's batch (0: auto, <= 4 x pp)")
    p.add_argument("--distributed", action="store_true",
                   help="one process a rank, the rendezvous from the launcher's environment "
                        "(torchrun's MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/LOCAL_RANK, or "
                        "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID)")
    p.add_argument("--dist-timeout", type=float, default=600.0,
                   help="seconds a collective may wait for the other ranks before it fails")
    # misc
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="where to train: the card (default) or the CPU")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--profile-steps", default=None,
                   help="capture a torch.profiler chrome trace over steps "
                        "'START:END' into <logs>/<name>/profile")
    p.add_argument("--tiny-model", action="store_true",
                   help="shrink towers to a test-size config (CI/integration tests)")
    p.add_argument("--seed", type=int, default=123)
    # distillation
    p.add_argument("--distillation", action="store_true")
    p.add_argument("--teacher-model-name", default=None,
                   help="struct name Vision@Text of the frozen teacher")
    p.add_argument("--teacher-weight-path", default=None)
    p.add_argument("--kd_loss_weight", "--kd-loss-weight", type=float, default=0.5)

    args = p.parse_args(argv)
    for name, val in get_default_params(args.vision_model).items():
        if getattr(args, name) is None:
            setattr(args, name, val)
    if args.lr is None:
        args.lr = 5.0e-4
    if args.beta1 is None:
        args.beta1, args.beta2, args.eps = 0.9, 0.999, 1e-8
    args.aggregate = not args.skip_aggregate
    return args
