#!/bin/sh
# The card runs of docs/port_r12/README.md, from the root of the repository:
#   sh docs/port_r12/card.sh OUT
# 1. the 600-step flagship runs, fp32 and bf16 side by side (as docs/port_r9/);
# 2. the expression latent over 84 fp32 steps under the port's two marchers
#    (the CUDA kernels, the compacted marcher), at the CPU comparison's cut
#    render (64x64 rays, 4 cameras of which 2 are held out, 8 frames) and at
#    the flagship's full render.
OUT=${1:?usage: card.sh OUT}
CUT="data.synthetic_height=64 data.synthetic_width=64 data.synthetic_cams=4 data.synthetic_frames=8"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/smi.txt"
python -m ava256_tpu_torch.flagship_runs "$OUT/flagship" --arms fp32,bf16 > "$OUT/flagship.out" 2>&1
echo "flagship_runs rc=$?" >> "$OUT/flagship.out"
for run in cut-cuda cut-xla full-xla; do
  case $run in
    cut-cuda) opts="$CUT" ;;
    cut-xla) opts="$CUT model.raymarch.backend=xla" ;;
    full-xla) opts="model.raymarch.backend=xla" ;;
  esac
  # shellcheck disable=SC2086
  python -m ava256_tpu_torch.flagship_runs "$OUT/$run" --arms fp32 --steps 84 $opts \
    > "$OUT/$run.out" 2>&1
  echo "flagship_runs rc=$?" >> "$OUT/$run.out"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >> "$OUT/smi.txt"
