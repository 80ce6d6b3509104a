"""Run one cell of the benchmark and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernels' build or load, the data, one warm job of the
cell's own shapes) is timed from the process's start.  Then jobs run back
to back until ``--seconds`` have passed; the job in flight finishes, and
the rates divide over the whole window.  With ``--trace 1`` a profiled
window of whole jobs follows, and the cell's per-layer metrics are read
from it.  Once the windows have closed and the peak memory is read, the
kept jobs' outputs are compared with the plain reference (``reference/``);
each number compared is printed beside its limit, last on standard error
and last in the result line."""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, trace  # noqa: E402
from benchmark.registry import Registry  # noqa: E402


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(chips: int, device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def window(job, ctx, seconds: float, keep: set, log) -> tuple:
    """Jobs back to back until ``seconds`` have passed: (elapsed,
    attempted, failed)."""
    import torch

    attempted = failed = 0
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else \
        (lambda: None)
    sync()
    t0 = time.perf_counter()
    while True:
        k = attempted
        attempted += 1
        try:
            job.run(k, keep=k in keep)
        except Exception:  # a failed job is counted and reported
            failed += 1
            log(f"job {k} failed:\n{traceback.format_exc()}")
        sync()
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return elapsed, attempted, failed


def main(argv=None, *, root=None, device=None, stdout=None) -> int:
    """One run.  ``device`` other than None skips the look for a card
    (the benchmark's tests run the rest on the CPU)."""
    args = parse(argv)
    stdout = stdout or sys.stdout
    reg = Registry(root or ROOT)
    try:
        cell = reg.workload(args.workload)
    except KeyError as e:
        fail(str(e))
    chips = int(cell["chips"])

    import torch

    if device is None:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: no result")
        if torch.cuda.device_count() < chips:
            fail(f"{chips} cards asked for, {torch.cuda.device_count()} "
                 "present: no result")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)

    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(cell["name"])
    ctx = harness.Context(cell=cell["name"], config=config, traffic=traffic,
                          seed=args.seed, device=device,
                          registry=reg)
    kind = reg.job_module(traffic["kind"])
    job = kind.Job(ctx)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    # -- set-up: everything before the first timed job ------------------
    job.setup()
    warm_failed = 0
    try:
        job.run(-1)                               # the warm job
    except Exception:  # reported, and the run is not correct
        warm_failed = 1
        log(f"the warm job failed:\n{traceback.format_exc()}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    ctx.work, ctx.spans = {}, {}
    job.last = None
    setup_s = harness.process_age()

    keep = harness.seeded_choice(args.seed, int(traffic["keep_from"]),
                             int(traffic["keep"]))
    window_s, attempted, failed = window(job, ctx, args.seconds, keep, log)
    failed += warm_failed
    # the timed window's own work and spans, apart from the traced one's
    ctx.window_work, ctx.window_spans = dict(ctx.work), dict(ctx.spans)
    metrics = {}
    if args.trace == 0:
        for m in reg.end_to_end(cell["name"]):
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = kind.E2E[m["name"]](ctx.window_work, window_s)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    out = {"correct": False, "attempted": attempted, "failed": failed,
           "metrics": metrics}
    summary = None
    if args.trace == 1:
        # the profiled window: whole jobs for at least trace_seconds
        before = dict(ctx.work)
        t_min = float(traffic["trace_seconds"])

        def traced():
            t0, k = time.perf_counter(), attempted
            while True:
                job.run(10**6 + k)
                k += 1
                if device.type == "cuda":
                    torch.cuda.synchronize()
                if time.perf_counter() - t0 >= t_min:
                    return
        summary = trace.profile(traced)
        ctx.traced_work = {k: v - before.get(k, 0)
                           for k, v in ctx.work.items()}
        ctx.trace = summary
        for m in reg.per_layer(cell["name"]):
            value = reg.layer_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    out["device"] = device_info(chips, device)
    if summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    job.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"JAX modules loaded in this process: {', '.join(loaded)}")

    numbers = job.check()
    checks = {name: {"value": numbers.get(name, float("inf")),
                     "limit": limits[name]} for name in limits}
    out["correct"] = bool(failed == 0 and checks and all(
        c["value"] <= c["limit"] for c in checks.values()))
    out["checks"] = checks
    log(f"card {harness.power_limit()!r}; setup_s {setup_s!r}; window_s "
        f"{window_s!r}; work {ctx.window_work}; spans {ctx.window_spans}")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
