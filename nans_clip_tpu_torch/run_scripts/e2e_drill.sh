#!/usr/bin/env bash
# Composed product drill — the full workflow as one command:
# dataset build -> finetune -> 3-stage eval (mean recall must improve)
# -> engine build -> daemon serve -> served features == offline.
# Chip scale trains ViT-B-16 + RoBERTa-base from scratch on the
# learnable synthetic set on the card; tiny runs on the CPU.
#
#   bash nans_clip_tpu_torch/run_scripts/e2e_drill.sh [tiny|chip] [WORKDIR] [OUT.json]

set -euo pipefail

SCALE=${1:-chip}
WORKDIR=${2:-/tmp/nans_drill}
OUT=${3:-DRILL.json}

EXTRA=()
if [ "${SCALE}" = "tiny" ]; then
    EXTRA+=(--platform cpu)
fi

exec python -m nans_clip_tpu_torch.drill --scale "${SCALE}" \
    --workdir "${WORKDIR}" --out "${OUT}" "${EXTRA[@]+"${EXTRA[@]}"}"
