#!/usr/bin/env bash
# FLIP-masked Flickr30K-CN finetune preset on the port (reference
# run_scripts/flickr30k_finetune_vit-b-16_rbt-base_flip.sh: +--mask-ratio 0.5).
set -e
DIR="$(dirname "$0")"
bash "${DIR}/flickr30k_finetune_vit-b-16_rbt-base.sh" "${1:-./datapath}" \
    --mask-ratio 0.5 --name flickr30k_finetune_vit-b-16_roberta-base_flip "${@:2}"
