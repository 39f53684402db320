#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this folder, heads the path: the package's module
# names must not shadow the standard library's.
sys.path[0] = ROOT
# Every kernel cache inside the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["USE_FLAX"] = "0"

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], harness.process_start()))
