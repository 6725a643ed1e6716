#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port ``neuralbarkcalculator_tpu_torch``.

Runs one cell of ``BENCHMARK.json`` once, on the CUDA card it is started
on, and prints the result as the last line of standard output:

    python3 portbench/run.py --workload fcn_resnet50.folder --seed 7 \
        --seconds 10 --trace 0

``--trace 1`` profiles the window and reports the per-layer metrics.
Without a CUDA card the run prints no result and exits with a nonzero
code. See portbench/lib/harness.py.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))

from portbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
