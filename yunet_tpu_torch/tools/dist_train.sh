#!/usr/bin/env bash
# Data-parallel training launcher, one process a card (reference
# tools/dist_train.sh role; the JAX package's runs one process a host).
#
# torchrun (python -m torch.distributed.run) starts NPROC ranks on this
# host, each running `python -m yunet_tpu_torch.tools.train CONFIG
# --distributed ...` on cuda:LOCAL_RANK over NCCL:
#
#   yunet_tpu_torch/tools/dist_train.sh yunet_n --work-dir work_dirs/n
#
# Several hosts: run it on each with the same MASTER_ADDR, MASTER_PORT and
# NNODES, and NODE_RANK set to the host's index:
#
#   NNODES=2 NODE_RANK=$i MASTER_ADDR=host0 MASTER_PORT=29500 \
#       yunet_tpu_torch/tools/dist_train.sh yunet_n --work-dir work_dirs/n
#
# On the CPU (gloo between ranks): NPROC=2 ... --device cpu.

set -euo pipefail
CONFIG=$1
shift

exec python -m torch.distributed.run \
    --nproc-per-node="${NPROC:-$(nvidia-smi -L | wc -l)}" \
    --nnodes="${NNODES:-1}" --node-rank="${NODE_RANK:-0}" \
    --master-addr="${MASTER_ADDR:-127.0.0.1}" \
    --master-port="${MASTER_PORT:-29500}" \
    -m yunet_tpu_torch.tools.train "$CONFIG" --distributed "$@"
