#!/bin/bash
# K1-K4's checks against their plain versions under compute-sanitizer
# memcheck and racecheck, one process per (tool, kernel), and without the
# tool (untimed, as under it), beside two controls
# that launch none of the port's kernels: a torch allocation and sum, and a
# plain CUDA C program (cudaMalloc, one kernel, cudaMemcpy) without torch.
# What a tool reports for a control it reports without the port's code.
#
# Run from the repo root on a CUDA host:
#   bash hyperscalees_t2i_tpu_torch/tools/sanitize_kernels.sh
# Logs go to chiprun_out/sanitize/<tool>-<case>.log; summary.txt holds each
# run's return code and every line the tool printed with its ========= prefix
# (backtraces left out).
set -u
out=chiprun_out/sanitize
mkdir -p "$out" build
summary=$out/summary.txt
: > "$summary"
say() { echo "$*" | tee -a "$summary"; }
say "$(nvidia-smi --query-gpu=name,power.limit,driver_version --format=csv,noheader)"
say "$(python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)')"
CS=$(command -v compute-sanitizer || echo /usr/local/cuda/bin/compute-sanitizer)
say "$($CS --version | tail -1)"
NVCC=$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)

cat > build/sanitize_control.cu <<'CU'
#include <cstdio>
__global__ void twice(float *x, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] *= 2.0f;
}
int main() {
  const int n = 1024;
  float h[n], *d = nullptr;
  for (int i = 0; i < n; ++i) h[i] = float(i);
  cudaError_t e = cudaMalloc(&d, n * sizeof(float));
  if (e != cudaSuccess) { printf("cudaMalloc: %s\n", cudaGetErrorString(e)); return 1; }
  cudaMemcpy(d, h, n * sizeof(float), cudaMemcpyHostToDevice);
  twice<<<(n + 255) / 256, 256>>>(d, n);
  e = cudaMemcpy(h, d, n * sizeof(float), cudaMemcpyDeviceToHost);
  if (e != cudaSuccess) { printf("kernel: %s\n", cudaGetErrorString(e)); return 1; }
  printf("control: h[1023] = %.1f\n", h[n - 1]);
  cudaFree(d);
  return 0;
}
CU
$NVCC -O2 -arch=sm_90a -o build/sanitize_control build/sanitize_control.cu || { say "control build failed"; exit 1; }
t0=$(date +%s)
python3 -c "import chip_smoke; chip_smoke.phase_build()" > "$out/build.log" 2>&1
say "kernel build rc=$? $(( $(date +%s) - t0 )) s"

declare -A CMD=(
  [control-c]="build/sanitize_control"
  [control-torch]="python3 -c 'import torch; x = torch.ones(1024, device=\"cuda\"); print(\"control:\", float(x.sum()))'"
  [k1]="python3 -c 'import torch, chip_smoke; chip_smoke.kernel_checks_once(torch, \"k1\")'"
  [chain]="python3 -c 'import torch, chip_smoke; chip_smoke.kernel_checks_once(torch, \"chain\")'"
  [k4]="python3 -c 'import torch, chip_smoke; chip_smoke.kernel_checks_once(torch, \"k4\")'"
  [k4inf]="python3 -c 'import torch, chip_smoke; chip_smoke.kernel_checks_once(torch, \"k4inf\")'"
)
for case in control-c control-torch k1 chain k4 k4inf; do
  t0=$(date +%s)
  eval "${CMD[$case]}" > "$out/none-$case.log" 2>&1
  say "== no tool, $case: rc=$?, $(( $(date +%s) - t0 )) s | $(tail -1 "$out/none-$case.log" | cut -c1-200)"
done
for tool in memcheck racecheck; do
  for case in control-c control-torch k1 chain k4 k4inf; do
    t0=$(date +%s)
    eval "timeout -k 10 300 $CS --tool $tool ${CMD[$case]}" > "$out/$tool-$case.log" 2>&1
    rc=$?
    say "== $tool $case: rc=$rc, $(( $(date +%s) - t0 )) s"
    grep -E '^=========' "$out/$tool-$case.log" | grep -vE 'Host Frame|Saved host backtrace|^========= *$' \
      | cut -c1-200 | sed 's/^/   /' | tee -a "$summary"
    grep -E '^(control:|\[checks-once\]|torch\.|RuntimeError|AssertionError)' "$out/$tool-$case.log" \
      | cut -c1-200 | sed 's/^/   /' | tee -a "$summary"
  done
done
