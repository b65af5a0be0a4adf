#!/bin/bash
# Launch-script parity with the reference
# (mDT/experiments/hateful_discussions/run_train.sh:28-65), calling the
# PyTorch port's launcher: positional args
#   $1 num_fusion_layers  $2 num_bottleneck_tokens  $3 spatial_pos_max
#   $4 num_graph_stack    $5 num_fusion_stack       $6 split
# and every further argument passed on to the launcher (after these flags,
# so a later flag wins). Canonical published run: bash run_train.sh 8 4 5 2 2 0
# (sample_run.sh). SAVE_DIR sets --save-dir; RESTORE_FILE=<checkpoint>
# adds --restore-file <checkpoint> --reset-optimizer (the two-stage
# transfer, run_train.sh:57-63).
#
# One difference from the JAX package's copy: --hf-init (the pretrained
# BERT/ViT towers) is passed only with HF_INIT=1, since the pretrained
# weights are not in the repository. With HF_INIT=1 and HF_HOME (or
# HF_HUB_CACHE) pointing at a cache that holds bert-base-uncased and
# google/vit-base-patch16-224, the launcher gets the JAX copy's argv.
set -euo pipefail

FUSION=${1:-8}
BOTTLENECK=${2:-4}
SPATIAL=${3:-5}
GRAPH_STACK=${4:-2}
FUSION_STACK=${5:-2}
SPLIT=${6:-0}

SAVE_DIR=${SAVE_DIR:-"ckpts/L_${FUSION}-B_${BOTTLENECK}-S_${SPATIAL}-GS_${GRAPH_STACK}-FS_${FUSION_STACK}-split_${SPLIT}"}
RESTORE=${RESTORE_FILE:-}

INIT=()
if [[ "${HF_INIT:-0}" == "1" ]]; then
  INIT+=(--hf-init)
fi
EXTRA=()
if [[ -n "$RESTORE" ]]; then
  EXTRA+=(--restore-file "$RESTORE" --reset-optimizer)
fi

python -m multimodaldiscussiontransformer_tpu_torch.train.launch \
  --task node_prediction --criterion node_cross_entropy \
  --arch multi_graphormer_base --dataset-name hateful_discussions \
  --split "$SPLIT" \
  --num-fusion-layers "$FUSION" --num-bottleneck-tokens "$BOTTLENECK" \
  --spatial-pos-max "$SPATIAL" --num-graph-stack "$GRAPH_STACK" \
  --num-fusion-stack "$FUSION_STACK" \
  --encoder-embed-dim 768 --encoder-ffn-embed-dim 768 \
  --encoder-attention-heads 12 --encoder-layers 12 \
  --dropout 0.4 --attention-dropout 0.3 --act-dropout 0.3 \
  --lr 3e-5 --end-learning-rate 3e-7 --power 1 \
  --warmup-updates 3246 --total-num-update 10820 \
  --adam-eps 1e-8 --weight-decay 0.01 --clip-norm 0 \
  --batch-size 12 --update-freq 3 --max-epoch 37 \
  --positive-weight 1.5 --negative-weight 1.0 \
  --freeze-initial-encoders ${INIT[@]+"${INIT[@]}"} \
  --validate-interval-updates 300 \
  --save-dir "$SAVE_DIR" \
  ${EXTRA[@]+"${EXTRA[@]}"} \
  "${@:7}"
