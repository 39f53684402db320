#!/usr/bin/env python3
"""Run one cell once with --trace 1, as run.py does, and print after its
result line one more: {"layers": ...}, the traced window by the program's
spans (portbench/spans.py), per traced unit: eager and whole device ms,
host syncs and idle ms by innermost span, the ten longest idle gaps and
the ten costliest eager operations with their span, and the program's
counters.

    python3 portbench/trace_layers.py --workload <cell> --seed <n> --seconds <s>
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["USE_FLAX"] = "0"

from portbench import harness, spans  # noqa: E402

if __name__ == "__main__":
    rc = harness.main(sys.argv[1:] + ["--trace", "1"], harness.process_start())
    print(json.dumps({"layers": spans.last()}), flush=True)
    sys.exit(rc)
