#!/usr/bin/env bash
# Sequential evaluation over the shifted-distribution DVM configs with the
# PyTorch port (the counterpart of run_dist_shifts.sh: one run per shifted
# dataset config, same CLI shape). The shifted YAMLs name no data: pass the
# split directories in "$@" (e.g. data_base=... data_val=...).
set -euo pipefail

FRACTION="${FRACTION:-0.1}"
CONFIG="${CONFIG:-config_dvm_STiL}"
CHECKPOINT="${CHECKPOINT:-}"

for shift in normal black b-s-g b-s-b-g-w miles adv_year labels; do
  ds="dvm_all_server_reordered_SemiPseudo_${FRACTION}_${shift}"
  echo "=== ${CONFIG} on ${ds} ==="
  python -m stil_tta_torch.run --config-name "${CONFIG}" \
    "dataset=${ds}" test=True evaluate=False \
    ${CHECKPOINT:+checkpoint=${CHECKPOINT}} \
    "logdir=runs/shifts/${shift}_${FRACTION}" "$@"
done
