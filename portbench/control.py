#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip at the cell's
own size, many seeds in one process:

  program: the program's numbers against the reference (sound runs: the
    lower readings);
  control: the reference in fp8 (e4m3, one scale per tensor: the precision
    below the configuration's bf16) put in the program's place;
  half_batch (training): the reference on the first half of each batch,
    its means taken over that half, put in the program's place;
  pose_frozen, window_bwd_zeroed (training, where the configuration
    trains the box poses): the reference with the pose table frozen
    (translation and rotation), and with the objects' windowed encoding
    cut from its inputs (the photometric pose gradient lost, the
    box-surface prior's kept), put in the program's place.
A state left unchanged reads 1 on change_gap and needs no run.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--program_seeds 1-12]

Prints one JSON line per seed and reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from portbench import cells, compare, harness  # noqa: E402
from portbench.modes import render as render_mode  # noqa: E402
from portbench.modes import train as train_mode  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += range(int(a), int(b) + 1)
        elif part:
            out.append(int(part))
    return out


def run_for(name: str, seed: int, device) -> harness.Run:
    cell = cells.cell(name)
    return harness.Run(name, seed, 0.0, False, device, cell["workload"], cell["config"], cell["chips"])


def train_readings(run: harness.Run, program: bool, control: bool) -> dict:
    """{reading: numbers} of one seed."""
    out = {}
    if program:
        driver = train_mode.Driver(run)
        driver.release()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        out["program"] = driver.check()
    if control:
        x = train_mode.Inputs(run)
        ref = x.reference()
        kinds = [("control", {"precision": "fp8"}), ("half_batch", {"half": True})]
        if "pose_rows" in ref:
            kinds += [(f, {"fault": f}) for f in train_mode.FAULTS]
        for what, kw in kinds:
            out[what] = compare.train_numbers(x.reference(**kw), ref)
    return out


def render_readings(run: harness.Run, program: bool, control: bool) -> dict:
    """{reading: numbers} of one seed: the program's views against the
    reference's, and the fp8 reference's against the float32 one's, on as
    many views as a run compares."""
    out = {}
    n = run.workload["traffic"]["check_views"]
    if program:
        driver = render_mode.Driver(run)
        for i in range(n):
            driver.step(driver.draw(i))
        driver.release()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        out["program"] = driver.check()
    if control:
        x = render_mode.Inputs(run)
        numbers = {}
        for v in range(n):
            for k, val in compare.render_numbers(x.reference(v, precision="fp8"), x.reference(v)).items():
                numbers[k] = max(numbers.get(k, 0.0), val)
        out["control"] = numbers
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="seeds of the control and the faults")
    p.add_argument("--program_seeds", default="", help="seeds of the program's sound runs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    mode = cells.cell(args.workload)["workload"]["mode"]
    todo = {}
    for s in seeds(args.program_seeds):
        todo.setdefault(s, [False, False])[0] = True
    for s in seeds(args.seeds):
        todo.setdefault(s, [False, False])[1] = True
    for s, (program, control) in sorted(todo.items()):
        t0 = time.perf_counter()
        readings = {"train": train_readings, "render": render_readings}[mode](
            run_for(args.workload, s, dev), program, control)
        for what, numbers in readings.items():
            print(json.dumps({"workload": args.workload, "seed": s, "reading": what, **numbers}),
                  flush=True)
        print(f"seed {s}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
