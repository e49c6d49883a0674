#!/usr/bin/env bash
# Flickr30K-CN finetune preset on the port (reference flickr30k_finetune_vit-b-16_rbt-base.sh).
set -e
DIR="$(dirname "$0")"
DATAPATH=${1:-"./datapath"}

python -m nans_clip_tpu_torch.training.main \
    --train-data "${DATAPATH}/datasets/Flickr30k-CN/train" \
    --val-data "${DATAPATH}/datasets/Flickr30k-CN/valid" \
    --name flickr30k_finetune_vit-b-16_roberta-base \
    --logs "${DATAPATH}/experiments/" \
    --vision-model ViT-B-16 \
    --text-model RoBERTa-wwm-ext-base-chinese \
    --clip-weight-path "${DATAPATH}/pretrained_weights/clip_cn_vit-b-16.pt" \
    --bert-weight-path "${DATAPATH}/pretrained_weights/clip_cn_vit-b-16.pt" \
    --batch-size 128 --valid-batch-size 128 \
    --lr 5e-5 --wd 0.001 --warmup 100 --max-epochs 3 \
    --valid-epoch-interval 1 --save-epoch-frequency 1 \
    --log-interval 10 --context-length 52 --use-augment \
    "${@:2}"
