#!/usr/bin/env bash
# The port's pretraining launcher: torchrun on the port's trainer
# (simclr_pytorch_distributed_tpu_torch.train.supcon) on the card, with the
# reference run_supcon.sh's recipe flags; --ngpu 2 keeps the reference's
# 2-GPU gradient scale.
#
# Exit-75 contract: 75 means "preempted, state saved, re-run with --resume
# <run_dir>". By default the launch is handed to the port's supervisor
# (python -m simclr_pytorch_distributed_tpu_torch.supervise), which closes
# the loop for every failure class (preempt resume, crash backoff-retry,
# liveness stall kill, resize) and records each decision in
# <workdir>/supervise/events.jsonl. SUPERVISE=0 falls back to a bounded
# shell loop (exit 75 only). PREEMPT_RETRIES bounds relaunches in both
# modes; NPROC_PER_NODE sets the process count (default 1), and under the
# supervisor a resize_request file changes it.
#
# The child is parallel/torchrun.py: torchrun's own agent and flags, with
# the workers' typed exit codes (75, 3, 2, 1) kept as its own exit code and
# a SIGTERM passed on to the workers.

set -uo pipefail

here=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
export PYTHONPATH="$(dirname "$here")${PYTHONPATH:+:$PYTHONPATH}"

max_retries=${PREEMPT_RETRIES:-3}
nproc=${NPROC_PER_NODE:-1}

# honor a --workdir override in the passthrough args (the trainer's
# default); both argparse spellings: '--workdir DIR' and '--workdir=DIR'
workdir=./work_space
prev=
for a in "$@"; do
  if [ "$prev" = "--workdir" ]; then workdir=$a; fi
  case "$a" in --workdir=*) workdir=${a#--workdir=} ;; esac
  prev=$a
done

trainer=(python -m simclr_pytorch_distributed_tpu_torch.parallel.torchrun --standalone
         -m simclr_pytorch_distributed_tpu_torch.train.supcon
         --syncBN --epochs 100 --batch_size 256 --learning_rate 0.5 --temp 0.5
         --cosine --method SimCLR --ngpu 2)

if [ "${SUPERVISE:-1}" != "0" ]; then
  # the supervisor appends --resume itself (argparse last-wins over any
  # user-supplied --resume) and exits with the final child's code.
  # Liveness-kill is opt-in (off: the supervisor observes only):
  #   SUPERVISE_STALL_SECS=300   kill and resume when the flush boundary
  #                              stalls that long (well above the first step)
  #   SUPERVISE_METRICS_PORT=N   the trainer's /metrics sidecar and the
  #                              supervisor's scrape on port N
  sup_args=()
  trainer_args=()
  if [ -n "${SUPERVISE_STALL_SECS:-}" ]; then
    sup_args+=(--stall_secs "$SUPERVISE_STALL_SECS")
    # the trainer's watchdog is the dump channel of the stall verdict:
    # without it (and without a metrics port) the deadline would watch nothing
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
    ${sup_args[@]+"${sup_args[@]}"} \
    -- \
    "${trainer[@]}" "$@" ${trainer_args[@]+"${trainer_args[@]}"}
fi

# ---------------------------------------------------------- SUPERVISE=0
# resume_args comes after "$@": argparse is last-wins, so on a retry the
# freshly resolved run folder beats any stale --resume the user passed
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
  # newest pretrain run folder; probe/CE folders are classifier_*/ce_*.
  # Filter on the BASENAME ($(NF-1): the paths end in /), not the whole
  # path: a workdir like /data/ce_experiments must not hide every candidate
  run_dir=$(ls -1dt "$workdir"/*_models/*/ 2>/dev/null \
            | awk -F/ '$(NF-1) !~ /^(classifier_|ce_)/' | head -1 || true)
  if [ -n "$run_dir" ]; then
    resume_args=(--resume "$run_dir")
  else
    resume_args=()
  fi
  echo "run_supcon.sh: preempted (exit 75); retry $attempt/$max_retries," \
       "resuming from '${run_dir:-scratch}'" >&2
done
