#!/usr/bin/env bash
# End-to-end quickstart of the PyTorch port on synthetic data (no renderer):
# generate -> prepare -> train -> denoise -> evaluate, the five steps and
# the config of examples/quickstart.sh through deepdenoiser_tpu_torch.
# Runs on the CUDA card; DEVICE=cpu runs it on the CPU instead (every
# command that takes --device gets --device cpu).
set -euo pipefail
cd "$(dirname "$0")/.."

WORK=${1:-build/quickstart_torch}
PY=${PYTHON:-python}
DEVICE_FLAG=""
if [ "${DEVICE:-cuda}" = cpu ]; then DEVICE_FLAG="--device cpu"; fi

echo "== 1. synthetic render root (stands in for Blender/Cycles) =="
$PY -m deepdenoiser_tpu_torch.cli synth-data --out "$WORK/renders" \
    --frames 4 --size 96 --spp 4 16 --seed 1

echo "== 2. prepare training shards =="
$PY - <<EOF
from deepdenoiser_tpu_torch import config as C
cfg = C.ExperimentConfig(
    name="quickstart",
    model=C.ModelConfig(base_width=16, depth=2, convs_per_level=1,
                        act="leaky_relu", predict_residual=True),
    data=C.DataConfig(crop=48, crops_per_frame=16, batch_size=8, mode="rgb",
                      validation_fraction=0.25),
    train=C.TrainConfig(steps=300, warmup_steps=10, learning_rate=3e-3,
                        schedule="constant", log_every=50, eval_every=150,
                        checkpoint_every=150),
    infer=C.InferenceConfig(tile=0, compute_dtype="float32"),
)
C.save(cfg, "$WORK/config.json")
EOF
$PY -m deepdenoiser_tpu_torch.cli prepare-data --config "$WORK/config.json" \
    --renders "$WORK/renders" --out "$WORK/shards"

echo "== 3. train (auto-resumes if re-run) =="
$PY -m deepdenoiser_tpu_torch.cli train --config "$WORK/config.json" \
    --workdir "$WORK/run" --shards "$WORK/shards" $DEVICE_FLAG

echo "== 4. denoise one frame =="
FRAME=$(ls -d "$WORK"/renders/frame*/spp4_seed0 | head -1)
$PY -m deepdenoiser_tpu_torch.cli denoise --config "$WORK/config.json" \
    --checkpoint "$WORK/run/checkpoints" --frame "$FRAME" \
    --out "$WORK/denoised.exr" $DEVICE_FLAG

echo "== 5. PSNR/SSIM + latency over the render root =="
$PY -m deepdenoiser_tpu_torch.cli eval --config "$WORK/config.json" \
    --checkpoint "$WORK/run/checkpoints" --renders "$WORK/renders" $DEVICE_FLAG

echo "done: outputs in $WORK"
