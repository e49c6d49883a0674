#!/usr/bin/env bash
# Distillation finetune preset on the port (reference *_distillation.sh:
# +--distillation --teacher-model-name). The teacher is any built model
# struct with a weight path.
set -e
DIR="$(dirname "$0")"
DATAPATH=${1:-"./datapath"}
bash "${DIR}/muge_finetune_vit-b-16_rbt-base.sh" "${DATAPATH}" \
    --distillation \
    --teacher-model-name "ViT-H-14@RoBERTa-wwm-ext-large-chinese" \
    --teacher-weight-path "${DATAPATH}/pretrained_weights/clip_cn_vit-h-14.pt" \
    --kd_loss_weight 0.5 \
    --name muge_finetune_vit-b-16_roberta-base_distillation "${@:2}"
