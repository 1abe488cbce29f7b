#!/bin/bash
# Benchmark harness entry point — the framework's analogue of the
# reference's SLURM run.sh.  Builds the native serial backend, runs the
# serial-vs-GPU comparison on the configs/ workloads, and writes the
# reference-schema CSVs into results/.
#
# Usage:
#   bash run.sh                 # workload 1 (256^2), 3 runs each
#   bash run.sh --tests 1,2     # more workloads (serial side gets SLOW)
#   bash run.sh --skip-serial --tests 1,2,3,4   # reference serial numbers
set -euo pipefail
cd "$(dirname "$0")"

echo "==== Building native serial backend ===="
make -C csrc

echo "==== Serial vs GPU Comparison ===="
python scripts/run_benchmarks.py "$@"
