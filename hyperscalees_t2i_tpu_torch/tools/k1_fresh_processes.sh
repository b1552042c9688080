#!/bin/bash
# K1's checks against its plain version, each run first in a fresh process
# (the condition of the one driver-run failure), 20 times, untimed.
# Run from the repo root on a CUDA host:
#   bash hyperscalees_t2i_tpu_torch/tools/k1_fresh_processes.sh
# Logs go to chiprun_out/k1_fresh_<i>.log.
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c "import chip_smoke; chip_smoke.phase_build()" > /dev/null 2>&1 || { echo build failed; exit 1; }
fail=0
for i in $(seq 1 20); do
  if python3 -c "import torch, chip_smoke; chip_smoke.kernel_checks_once(torch, 'k1')" > chiprun_out/k1_fresh_$i.log 2>&1; then
    echo "process $i: passed"
  else
    echo "process $i: FAILED"; fail=$((fail+1)); tail -5 chiprun_out/k1_fresh_$i.log
  fi
done
echo "failed $fail of 20"
[ "$fail" -eq 0 ]
