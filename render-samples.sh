#!/bin/bash
# Batch regression sweep, equivalent to the reference's render-samples.sh
# (which times every sample_data/gltf/*.gltf at 1000x1000 @100spp and prints
# colored ok/fail).  Course glTF files are supplied out-of-band; this sweep
# also covers the homebrew scenes the reference ships but cannot render.
#
# Per-scene wall-clock times are appended to out/samples/timings.jsonl so the
# outputs record the workload they were actually rendered at.
cd "$(dirname "$0")"
W=${W:-1000}; H=${H:-1000}; SPP=${SPP:-100}
# Per-scene wall-clock bound (default 40 min): tight enough that one
# pathological scene cannot eat the sweep.
SCENE_TIMEOUT=${SCENE_TIMEOUT:-2400}
mkdir -p out/samples
: > out/samples/timings.jsonl
shopt -s nullglob
# The reference sweep renders every sample glTF; the course files are
# gitignored upstream, so generate the procedural glTF fixtures (Cornell,
# enclosed atrium, textured sphere field) to stand in for them.
GLTF_DIR=${GLTF_DIR:-out/sweep_gltf}
python - "$GLTF_DIR" <<'PYEOF'
import sys, os
d = sys.argv[1]
os.makedirs(d, exist_ok=True)
from tpu_pathtracer.utils.testscenes import (
    make_cornell_gltf, make_atrium_gltf, make_sphere_field_gltf)
make_cornell_gltf(os.path.join(d, "cornell.gltf"))
make_atrium_gltf(os.path.join(d, "atrium_57k.gltf"), detail=1)
make_sphere_field_gltf(os.path.join(d, "field_82k.gltf"), 64, 3, textured=True)
PYEOF
# Owen-Sobol end-to-end at sweep scale (the low-discrepancy sampler is
# reachable only via env): one full-size Cornell render with camera + bounce-pair
# Sobol enabled, recorded under its own name.
name="cornell@sobol"
t0=$(date +%s.%N)
if TPU_PATHTRACER_JITTER=sobol TPU_PATHTRACER_LOWDISC=sobol \
   timeout "$SCENE_TIMEOUT" ./run.sh "$GLTF_DIR/cornell.gltf" "$W" "$H" "$SPP" \
   "out/samples/cornell_sobol.ppm"; then
  dt=$(echo "$(date +%s.%N) $t0" | awk '{printf "%.1f", $1 - $2}')
  echo "{\"scene\": \"$name\", \"width\": $W, \"height\": $H, \"spp\": $SPP, \"seconds\": $dt, \"ok\": true}" >> out/samples/timings.jsonl
  echo -e "\e[0;32m$name ok (${dt}s)\e[0m"
else
  dt=$(echo "$(date +%s.%N) $t0" | awk '{printf "%.1f", $1 - $2}')
  echo "{\"scene\": \"$name\", \"width\": $W, \"height\": $H, \"spp\": $SPP, \"seconds\": $dt, \"ok\": false}" >> out/samples/timings.jsonl
  echo -e "\e[0;31m$name failed (${dt}s)\e[0m"
fi
scenes=("$GLTF_DIR"/*.gltf sample_data/gltf/*.gltf /root/reference/sample_data/*.txt /root/reference/sample_data/homebrew_primitives/*.txt)
for f in "${scenes[@]}"; do
  name=$(basename "$f")
  t0=$(date +%s.%N)
  if timeout "$SCENE_TIMEOUT" ./run.sh "$f" "$W" "$H" "$SPP" "out/samples/${name%.*}.ppm"; then
    dt=$(echo "$(date +%s.%N) $t0" | awk '{printf "%.1f", $1 - $2}')
    echo "{\"scene\": \"$name\", \"width\": $W, \"height\": $H, \"spp\": $SPP, \"seconds\": $dt, \"ok\": true}" >> out/samples/timings.jsonl
    echo -e "\e[0;32m$name ok (${dt}s)\e[0m"
  else
    dt=$(echo "$(date +%s.%N) $t0" | awk '{printf "%.1f", $1 - $2}')
    echo "{\"scene\": \"$name\", \"width\": $W, \"height\": $H, \"spp\": $SPP, \"seconds\": $dt, \"ok\": false}" >> out/samples/timings.jsonl
    echo -e "\e[0;31m$name failed (${dt}s)\e[0m"
  fi
done
