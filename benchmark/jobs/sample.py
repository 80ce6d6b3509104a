"""Job kind ``sample``: one sampling job of the port, as its users run it.

* ``driver: "w_eval"``: ``experiments.runner.run_w_eval`` of a
  ``w_eval_config(target, kernel, fused=...)`` at the traffic's seeds and
  budget, writing its npz and manifest into a fresh directory under
  ``TMPDIR``, deleted after the job;
* ``driver: "mcmc"``: ``MCMC(arwmh(target, ARWMHConfig(num_warmup,
  fused)), ...).run(generator)``, then ``get_samples()`` copied to the host.

A job counts (num_warmup + num_samples) × chains chain-iterations and
num_samples / thinning × chains draws; a ``w_eval`` traffic's
``warm_budget`` gives the warm job's fewer steps.  The
jobs that ``harness.seeded_choice`` picks, and the window's last, keep their
draws, potentials and final state for ``check``."""

from __future__ import annotations

import shutil
import tempfile

import numpy as np

from benchmark.harness import job_seed, reference_seed
from benchmark.reference import compare

# end-to-end metrics from the timed window's work and length
E2E = {"chain_iters_per_s": lambda work, window_s:
       work.get("chain_iters", 0) / window_s}


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.kept = {}
        self.last = None
        self._final = None

    # -- set-up -------------------------------------------------------
    def setup(self) -> None:
        import adaptive_mcmc_tpu_torch as amt
        import adaptive_mcmc_tpu_torch.parallel as parallel

        self.amt = amt
        self.chains = int(self.t["chains"])
        self.iters_per_job = (int(self.t["num_warmup"])
                              + int(self.t["num_samples"])) * self.chains
        self.draws_per_job = int(self.t["num_samples"]) \
            // int(self.t["thinning"]) * self.chains
        # the final state of run_w_eval's run: run_w_eval keeps only the
        # draws, so the call it makes is recorded on its way out
        run_sharded = parallel.run_mcmc_sharded

        def recorded(*a, **kw):
            out = run_sharded(*a, **kw)
            self._final = out[2]
            return out

        parallel.run_mcmc_sharded = recorded

    # -- one job ------------------------------------------------------
    def run(self, k: int, keep: bool = False) -> None:
        seed = job_seed(self.ctx.seed, k)
        if k < 0 and "warm_budget" in self.t:
            # the warm job: the same kernels, chains and thinning, fewer
            # steps (nothing is built per step count)
            out = self._w_eval(seed, **self.t["warm_budget"])
            self.last = out
            return
        out = self._w_eval(seed) if self.t["driver"] == "w_eval" else \
            self._mcmc(seed)
        self.ctx.count("chain_iters", self.iters_per_job)
        self.ctx.count("draws", self.draws_per_job)
        self.ctx.count("jobs", 1)
        self.last = out
        if keep:
            self.kept[k] = out

    def _w_eval(self, seed: int, num_warmup=None, num_samples=None):
        from adaptive_mcmc_tpu_torch.experiments.configs import w_eval_config
        from adaptive_mcmc_tpu_torch.experiments.runner import run_w_eval

        t, cfg = self.t, self.ctx.config
        out_dir = tempfile.mkdtemp(prefix="amt_bench_", dir=self.ctx.tmp_root)
        try:
            rc = w_eval_config(
                cfg["target"], t["kernel"],
                num_warmup=int(num_warmup or t["num_warmup"]),
                num_samples=int(num_samples or t["num_samples"]),
                thinning=int(t["thinning"]), n_seeds=self.chains,
                seed0=seed, out_dir=out_dir, fused=t["fused"])
            path = run_w_eval(rc, verbose=False, device=self.ctx.device)
            # every job reads its draws back, so that kept and unkept jobs
            # cost the same
            with np.load(path, allow_pickle=False) as data:
                x = data["samples"]
                pe = data["potential_energy"]
            return self._outputs(x, pe, self._final, seed)
        finally:
            self._final = None
            shutil.rmtree(out_dir, ignore_errors=True)

    def _mcmc(self, seed: int):
        import torch
        from adaptive_mcmc_tpu_torch.experiments.runner import TARGETS

        amt, t = self.amt, self.t
        target = TARGETS[self.ctx.config["target"]]()
        kernel = amt.arwmh(target, amt.ARWMHConfig(
            num_warmup=int(t["num_warmup"]), fused=bool(t["fused"])))
        mcmc = amt.MCMC(kernel, num_warmup=int(t["num_warmup"]),
                        num_samples=int(t["num_samples"]),
                        thinning=int(t["thinning"]), n_chains=self.chains)
        g = torch.Generator(self.ctx.device).manual_seed(seed)
        mcmc.run(g, extra_fields=("potential_energy",))
        # what a user takes away: the draws on the host, by chain
        x = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
        pe = mcmc.get_extra_fields()["potential_energy"]
        x = x.cpu().numpy().transpose(1, 0, 2)        # (chains, draws, d)
        pe = pe.cpu().numpy().T
        return self._outputs(x, pe, mcmc.last_state, seed)

    @staticmethod
    def _outputs(x, pe, state, seed: int) -> dict:
        """The job's outputs on the host: its seed, the draws (chains,
        draws, d) and their potentials, and the final state's position,
        potential, clock and (ARWMH) mean acceptance."""
        out = {
            "seed": seed, "x": np.asarray(x), "pe": np.asarray(pe),
            "x_last": state.position.detach().cpu().numpy(),
            "pe_last": state.potential_energy.detach().cpu().numpy(),
            "i": int(state.i),
        }
        if hasattr(state, "mean_accept_prob"):
            out["map"] = state.mean_accept_prob.detach().cpu().numpy()
        return out

    # -- after the window ---------------------------------------------
    def release(self) -> None:
        import gc

        self._final = None
        gc.collect()

    def outputs(self) -> list:
        """The kept jobs' outputs and the window's last job's."""
        outs = list(self.kept.values())
        if self.last is not None and all(o is not self.last for o in outs):
            outs.append(self.last)
        return outs

    def check(self) -> dict:
        """The compared numbers over the kept jobs: the worst of each."""
        return compare.sample_numbers(
            self.outputs(), self.ctx.config, self.t,
            seed=reference_seed(self.ctx.seed), device=self.ctx.device)

    def control(self, dtype: str = "bfloat16") -> dict:
        """The control's numbers: the reference in ``dtype`` in the
        program's place (its potential at the same draws, its law
        sample)."""
        return compare.sample_numbers(
            self.outputs(), self.ctx.config, self.t, dtype=dtype,
            seed=reference_seed(self.ctx.seed), device=self.ctx.device)

