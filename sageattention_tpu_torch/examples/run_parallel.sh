#!/usr/bin/env bash
# Multi-device launch (reference: example/run_parallel.sh).
#
# The reference launches torchrun --nproc_per_node=2 with xDiT degrees;
# here torchrun starts one process a rank and parallel_video.py builds the
# ("data", "seq", "heads") mesh over them.  By default every rank takes a
# card of its own over NCCL (DEVICE=cuda) at CogVideoX-2B's full geometry;
# DEVICE=cpu runs a gloo validation world on the CPU at a smoke size
# instead.  The degrees must multiply to DEVICES.
set -e
cd "$(dirname "$0")/../.."

: "${DEVICES:=8}"
: "${DEVICE:=cuda}"
smoke=()
scale=1.0
if [ "${DEVICE}" = cpu ]; then
    smoke=(--smoke)
    scale=0.15
fi
torchrun --standalone --nproc_per_node="${DEVICES}" \
    -m sageattention_tpu_torch.examples.parallel_video \
    --model cogvideox-2b \
    --ring_degree "${RING_DEGREE:-2}" \
    --ulysses_degree "${ULYSSES_DEGREE:-2}" \
    --cfg_parallel \
    --scale "${SCALE:-${scale}}" \
    --device "${DEVICE}" \
    "${smoke[@]}" \
    "$@"
