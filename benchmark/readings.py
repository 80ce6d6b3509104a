"""The readings that the limits of ``limits/<cell>.json`` are set from:
the compared numbers of sound runs of the program over many seeds, of the
controls (the reference in bfloat16, and in float16, the width of TF32's
mantissa, in the program's place, at the same outputs), and of runs with a
fault planted (``faults.py``), each at the cell's own size, with one
set-up for all seeds.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--jobs 2] [--fault unchanged|half|altered]

prints one JSON line per seed: the seed, the numbers and, without a
fault, the controls' numbers."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402
from benchmark.registry import Registry  # noqa: E402


def readings(workload: str, seeds: list, jobs: int = 2, fault=None,
             root=None, device=None):
    import torch

    reg = Registry(root or ROOT)
    cell = reg.workload(workload)
    traffic = reg.traffic(cell["traffic"])
    if device is None:
        device = torch.device("cuda", 0)
    ctx = harness.Context(cell=workload, config=reg.config(cell["config"]),
                          traffic=traffic, seed=seeds[0],
                          device=torch.device(device), registry=reg)
    job = reg.job_module(traffic["kind"]).Job(ctx)
    job.setup()
    job.run(-1)
    planted = faults.plant(traffic["kind"], fault) if fault else \
        contextlib.nullcontext()
    with planted:
        for seed in seeds:
            ctx.seed = seed
            job.kept, job.last = {}, None
            row = {"workload": workload, "seed": seed, "fault": fault}
            try:
                for k in range(jobs):
                    job.run(k, keep=True)
            except Exception as e:  # a job that fails is not correct
                row["failed"] = f"{type(e).__name__}: {e}"
                yield row
                continue
            row["numbers"] = job.check()
            if fault is None:
                row["control"] = job.control()
                row["control_fp16"] = job.control("float16")
            yield row


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--fault", choices=faults.FAULTS, default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(args.workload, seeds, args.jobs, args.fault):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
