#!/usr/bin/env bash
# FLIP-masked finetune preset on the port (reference *_flip.sh: +--mask-ratio 0.5).
set -e
DIR="$(dirname "$0")"
bash "${DIR}/muge_finetune_vit-b-16_rbt-base.sh" "${1:-./datapath}" \
    --mask-ratio 0.5 --name muge_finetune_vit-b-16_roberta-base_flip "${@:2}"
