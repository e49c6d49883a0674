#!/usr/bin/env bash
# Zero-shot classification preset on the port (reference run_scripts/zeroshot_eval.sh).
# args: DATAPATH DATASET VISION_MODEL TEXT_MODEL CKPT
set -e

DATAPATH=${1:-"./datapath"}
DATASET=${2:-"imagenet"}
VISION=${3:-"ViT-B-16"}
TEXT=${4:-"RoBERTa-wwm-ext-base-chinese"}
CKPT=${5:-"${DATAPATH}/pretrained_weights/clip_cn_vit-b-16.pt"}

python -m nans_clip_tpu_torch.eval.zeroshot_evaluation \
    --dataset "${DATASET}" \
    --datapath "${DATAPATH}/datasets/${DATASET}/test" \
    --resume "${CKPT}" \
    --vision-model "${VISION}" \
    --text-model "${TEXT}" \
    --save-dir "${DATAPATH}/zeroshot_predictions"
