"""Job kind ``grade``: grade one sweep cell's draws, as the sweep does.

A job makes ``sets`` sets of ``draws`` × d draws on the card (a
multivariate normal with the reference draws' mean and covariance, the
geometry of a converged sampler's output), writes them as a w_eval npz
under ``TMPDIR``, and runs ``experiments.evaluate.evaluate_run`` on it
against the reference draws with ``sweep.run_cell``'s settings (the
ε-auction for the exact W in batches of ``batch``, no Hungarian check, no
Sinkhorn).  The npz is deleted after the job.

The auction's rounds depend on the draws, so a window's cost would follow
the seed's draws; instead the jobs' draws come from a fixed pool of
``pool`` jobs (seeded by ``pool_seed``), and the run's seed orders the
pool, so that every run grades the same work in another order."""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

import numpy as np

from benchmark.harness import job_seed
from benchmark.reference import compare

# end-to-end metrics from the timed window's work and length
E2E = {"grade_s": lambda work, window_s: window_s / max(1, work.get(
    "sets", 0))}


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.kept = {}
        self.last = None

    def setup(self) -> None:
        import torch

        cfg = self.ctx.config
        self.gold = np.load(Path(cfg["data_dir"]) / cfg["gold"])
        g64 = self.gold.astype(np.float64)
        dev = self.ctx.device
        self.mean = torch.tensor(g64.mean(axis=0), dtype=torch.float32,
                                 device=dev)
        self.chol_t = torch.tensor(
            np.linalg.cholesky(np.cov(g64, rowvar=False)).T,
            dtype=torch.float32, device=dev)

    def sets(self, seed: int):
        """The job's sets (S, n, d) on the card, drawn from its seed."""
        import torch

        S, n = int(self.t["sets"]), int(self.t["draws"])
        g = torch.Generator(self.ctx.device).manual_seed(seed)
        z = torch.randn((S, n, self.mean.shape[0]), generator=g,
                        device=self.ctx.device)
        return self.mean + z @ self.chol_t

    def pool_seed(self, k: int) -> int:
        """The seed of job ``k``'s draws: entry ``order[k mod pool]`` of the
        pool, the order drawn from the run's seed (the warm job, k < 0,
        draws apart)."""
        pool = int(self.t["pool"])
        order = np.random.default_rng([self.ctx.seed % 2**64, 11]) \
            .permutation(pool)
        return job_seed(int(self.t["pool_seed"]),
                        int(order[k % pool]) if k >= 0 else -1)

    def run(self, k: int, keep: bool = False) -> None:
        from adaptive_mcmc_tpu_torch.experiments.evaluate import evaluate_run

        t = self.t
        sets = self.sets(self.pool_seed(k)).cpu().numpy()
        out_dir = Path(tempfile.mkdtemp(prefix="amt_bench_",
                                        dir=self.ctx.tmp_root))
        try:
            path = out_dir / "run.npz"
            np.savez(path, samples=sets, meta=json.dumps(
                {"config": {"fan_out": 1}}))
            timings: dict = {}
            columns = evaluate_run(
                path, self.gold, exact_w_solver="auction",
                exact_w_batch=int(t["batch"]), hungarian_check_seeds=0,
                sinkhorn=False, device=self.ctx.device, timings=timings)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        for name, seconds in timings.items():
            self.ctx.span(name, seconds)
        self.ctx.count("sets", len(sets))
        self.ctx.count("jobs", 1)
        self.last = {"sets": sets, "columns": columns}
        if keep:
            self.kept[k] = self.last

    def release(self) -> None:
        self.mean = self.chol_t = None

    def outputs(self) -> list:
        outs = list(self.kept.values())
        if self.last is not None and all(o is not self.last for o in outs):
            outs.append(self.last)
        return outs

    def check(self) -> dict:
        return compare.grade_numbers(self.outputs(), self.gold,
                                     int(self.t["batch"]))

    def control(self, dtype: str = "bfloat16") -> dict:
        return compare.grade_numbers(self.outputs(), self.gold,
                                     int(self.t["batch"]), dtype=dtype)
