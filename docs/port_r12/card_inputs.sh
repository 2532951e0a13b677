#!/bin/sh
# Which of the cut's inputs keeps the port's expression latent open: 61
# fp32 steps of the flagship on the card under the CUDA kernels, for each
# mix of the render size (64x64 or the flagship's 512x334) and the data's
# counts (4 cameras and 8 frames, or the flagship's 10 and 32):
#   sh docs/port_r12/card_inputs.sh OUT
OUT=${1:?usage: card_inputs.sh OUT}
R64="data.synthetic_height=64 data.synthetic_width=64"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/smi.txt"
for run in r64-c10-f32 r64-c4-f32 r64-c10-f8 full-c4-f8 r128-c4-f8; do
  case $run in
    r64-c10-f32) opts="$R64" ;;
    r64-c4-f32) opts="$R64 data.synthetic_cams=4" ;;
    r64-c10-f8) opts="$R64 data.synthetic_frames=8" ;;
    full-c4-f8) opts="data.synthetic_cams=4 data.synthetic_frames=8" ;;
    r128-c4-f8) opts="data.synthetic_height=128 data.synthetic_width=128 data.synthetic_cams=4
                      data.synthetic_frames=8" ;;
  esac
  # shellcheck disable=SC2086
  python -m ava256_tpu_torch.flagship_runs "$OUT/$run" --arms fp32 --steps 61 $opts \
    > "$OUT/$run.out" 2>&1
  echo "flagship_runs rc=$?" >> "$OUT/$run.out"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >> "$OUT/smi.txt"
