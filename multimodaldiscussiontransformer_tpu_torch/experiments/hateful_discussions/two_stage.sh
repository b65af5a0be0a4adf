#!/usr/bin/env bash
# Two-stage rehearsal, one command, on the PyTorch port (the small-scale
# analogue of the reference's run_train.sh:57-63 restore + reset-optimizer
# flow). DEVICE=cpu runs it on the CPU (default: the card).
#
# Usage: bash two_stage.sh [OUT_DIR] [N_TREES] [STAGE1_UPDATES] [STAGE2_UPDATES]
set -euo pipefail
OUT="${1:-${TMPDIR:-/tmp}/mdt_two_stage}"
N_TREES="${2:-200}"
S1="${3:-30}"
S2="${4:-120}"

exec python -m multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.two_stage \
  --out "$OUT" \
  --n-trees "$N_TREES" \
  --stage1-updates "$S1" \
  --stage2-updates "$S2" \
  --device "${DEVICE:-cuda}"
