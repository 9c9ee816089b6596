#!/usr/bin/env bash
# The port's linear-probe launcher: torchrun on the port's probe
# (simclr_pytorch_distributed_tpu_torch.train.linear) on the card, with the
# reference run_linear.sh's flags.
# Usage: simclr_pytorch_distributed_tpu_torch/run_linear.sh \
#          --ckpt work_space/cifar10_models/<run>/last.pth
#
# Exit-75 contract: the probe keeps no full-state checkpoints; on a
# preemption it keeps the best classifier so far and exits 75, and its
# --resume means "retrain from scratch". By default the launch is handed to
# the port's supervisor (python -m simclr_pytorch_distributed_tpu_torch.supervise);
# SUPERVISE=0 keeps a bounded shell loop. PREEMPT_RETRIES bounds relaunches
# in both; NPROC_PER_NODE sets the process count (default 1).

set -uo pipefail

here=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
export PYTHONPATH="$(dirname "$here")${PYTHONPATH:+:$PYTHONPATH}"

max_retries=${PREEMPT_RETRIES:-3}
nproc=${NPROC_PER_NODE:-1}

# the supervisor resolves run folders under the workdir; honor an override
# in the passthrough args (both argparse spellings)
workdir=./work_space
prev=
for a in "$@"; do
  if [ "$prev" = "--workdir" ]; then workdir=$a; fi
  case "$a" in --workdir=*) workdir=${a#--workdir=} ;; esac
  prev=$a
done

trainer=(python -m simclr_pytorch_distributed_tpu_torch.parallel.torchrun --standalone
         -m simclr_pytorch_distributed_tpu_torch.train.linear
         --learning_rate 5 --batch_size 256)

if [ "${SUPERVISE:-1}" != "0" ]; then
  # --all_run_dirs: the probe's run folders are the classifier_* ones the
  # pretrain-oriented default scan excludes; without it the supervisor's
  # run-folder channel (stall dumps, recorder events) would be blind here.
  # SUPERVISE_STALL_SECS / SUPERVISE_METRICS_PORT opt into liveness-kill as
  # in run_supcon.sh.
  sup_args=()
  trainer_args=()
  if [ -n "${SUPERVISE_STALL_SECS:-}" ]; then
    sup_args+=(--stall_secs "$SUPERVISE_STALL_SECS")
    trainer_args+=(--watchdog_secs "$SUPERVISE_STALL_SECS")
  fi
  if [ -n "${SUPERVISE_METRICS_PORT:-}" ]; then
    sup_args+=(--metrics_port "$SUPERVISE_METRICS_PORT")
    trainer_args+=(--metrics_port "$SUPERVISE_METRICS_PORT")
  fi
  exec python -m simclr_pytorch_distributed_tpu_torch.supervise \
    --workdir "$workdir" \
    --max_restarts "$max_retries" \
    --devices "$nproc" \
    --all_run_dirs \
    ${sup_args[@]+"${sup_args[@]}"} \
    -- \
    "${trainer[@]}" "$@" ${trainer_args[@]+"${trainer_args[@]}"}
fi

# ---------------------------------------------------------- SUPERVISE=0
export PET_NPROC_PER_NODE=$nproc
attempt=0
resume_args=()
while true; do
  "${trainer[@]}" "$@" ${resume_args[@]+"${resume_args[@]}"}
  rc=$?
  if [ "$rc" -ne 75 ] || [ "$attempt" -ge "$max_retries" ]; then
    exit "$rc"
  fi
  attempt=$((attempt + 1))
  resume_args=(--resume preempted-retry)
  echo "run_linear.sh: preempted (exit 75); retry $attempt/$max_retries" \
       "(the probe retrains from scratch)" >&2
done
