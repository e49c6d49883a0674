#!/usr/bin/env bash
# "FlashAttention" preset (reference *_flashattn.sh adds --use-flash-attention).
# On the card the fused attention sub-block kernels are already the default;
# this preset pins them explicitly (--attn-impl fused, ops/gates.py IMPLS).
set -e
DIR="$(dirname "$0")"
bash "${DIR}/muge_finetune_vit-b-16_rbt-base.sh" "${1:-./datapath}" \
    --attn-impl fused --name muge_finetune_vit-b-16_roberta-base_flashattn "${@:2}"
