"""Sample-quality evaluation against gold-standard reference draws
(PyTorch).

Counterpart of ``adaptive_mcmc_tpu/experiments/evaluate.py``: per seed,
compare the thinned draws to reference draws in the standard *comparison
space* (scale parameters log-transformed, non-centered theta recovered
from constrained reference draws) with moment-RMSE (p = 1), exact 1-1
Wasserstein, Sinkhorn and median-heuristic MMD, plus Geyer ESS columns,
and write a CSV.

Comparison spaces (must match eval_*.py exactly):
  * eight_schools:  [mu, log(tau), theta_base(8)]
  * diamonds:       [Intercept, b(24), log(sigma)]
  * kidiq:          [beta(3), log(sigma)]
These are the unconstrained flat layouts of the targets, so the comparison
space is simply the unconstrained samples.

The table is a dict of numpy columns in the JAX frame's column order, and
the CSV has ``DataFrame.to_csv``'s layout (a leading unnamed index column),
written with the ``csv`` module: the port needs no pandas.  The metrics
run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
import csv
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.experiments.configs import OUT_ROOT
from adaptive_mcmc_tpu_torch.experiments.runner import (
    TARGETS,
    build_kernel,
    run_device,
)
from adaptive_mcmc_tpu_torch.metrics import (
    pth_moment_rmse,
    wasserstein_sinkhorn,
)
from adaptive_mcmc_tpu_torch.models.data import DATA_DIR
from adaptive_mcmc_tpu_torch.utils import profiling

COLUMNS = ("rng_seed", "rmse_means", "wasserstein", "sinkhorn", "mmd",
           "ess_median", "ess_min")


# The sweep's reference run where no gold draws are vendored (eight
# schools, kidiq): the JAX sweep's settings (scripts/run_full_sweeps.py),
# given to make_reference_draws by the sweep, moments_parity and
# gold_spread alike
REFERENCE_RUN = dict(n_draws=10_000, n_chains=256, num_warmup=3000,
                     thinning=10, rng_seed=999)


def reference_settings(n_draws: int, *, n_chains: int, num_warmup: int,
                       thinning: int, rng_seed: int) -> dict:
    """The settings a reference run's cache is stamped with."""
    return {"n_draws": n_draws, "n_chains": n_chains,
            "num_warmup": num_warmup, "thinning": thinning,
            "rng_seed": rng_seed, "lr_decay": 2.0 / 3.0}


def make_reference_draws(
    target_name: str,
    n_draws: int = 10_000,
    *,
    kernel_name: str = "nuts",
    rng_seed: int = 999,
    cache_dir: str = f"{OUT_ROOT}/reference_draws",
    n_chains: int = 50,
    num_warmup: int = 2000,
    thinning: int = 20,
    device=None,
) -> np.ndarray:
    """Self-consistent gold standard: many parallel chains, long warmup,
    heavy thinning.  Cached to disk as ``<target>_<kernel>.npy`` beside a
    ``.json`` of the run's settings (:func:`reference_settings`); a cached
    run is reused only where its settings are these, and a cache without
    them or of other settings raises."""
    settings = reference_settings(n_draws, n_chains=n_chains,
                                  num_warmup=num_warmup, thinning=thinning,
                                  rng_seed=rng_seed)
    cache = Path(cache_dir) / f"{target_name}_{kernel_name}.npy"
    stamp = cache.with_suffix(".json")
    if cache.exists():
        cached = json.loads(stamp.read_text()) if stamp.exists() else None
        if cached != settings:
            raise ValueError(
                f"{cache} was built with {cached}, not {settings}: give "
                f"another cache_dir")
        return np.load(cache)
    from adaptive_mcmc_tpu_torch.infer.mcmc import run_mcmc

    dev = run_device(device)
    target = TARGETS[target_name]()
    per_chain = max(1, -(-n_draws // n_chains))  # ceil: never under-deliver
    kernel = build_kernel(
        kernel_name, target, lr_decay=settings["lr_decay"],
        num_warmup=num_warmup
    )
    samples, _, _ = run_mcmc(
        kernel,
        torch.Generator(dev).manual_seed(rng_seed),
        num_warmup=num_warmup,
        num_samples=per_chain * thinning,
        thinning=thinning,
        n_chains=n_chains,
    )
    out = samples.cpu().numpy().reshape(-1, target.dim)[:n_draws]
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.save(cache, out)
    stamp.write_text(json.dumps(settings) + "\n")
    return out


def posteriordb_reference_draws(target_name: str) -> Optional[np.ndarray]:
    """Load PosteriorDB gold-standard draws mapped into the comparison
    space, if a local PosteriorDB clone is available."""
    import os

    wd = os.environ.get("MCMC_WORKDIR")
    if not wd:
        return None
    # PosteriorDB layout: reference_posteriors/draws/draws/<name>.json(.zip)
    name_map = {
        "eight_schools": "eight_schools-eight_schools_noncentered",
        "diamonds": "diamonds-diamonds",
        "kidiq": "kidiq-kidscore_momhsiq",
    }
    root = (
        Path(wd) / "posteriordb" / "posterior_database"
        / "reference_posteriors" / "draws" / "draws"
    )
    pname = name_map.get(target_name)
    if pname is None:
        return None
    blob = None
    for cand in (root / f"{pname}.json", root / f"{pname}.json.zip"):
        if cand.exists():
            if cand.suffix == ".zip":
                import zipfile

                with zipfile.ZipFile(cand) as zf:
                    with zf.open(zf.namelist()[0]) as f:
                        blob = json.load(f)
            else:
                blob = json.loads(cand.read_text())
            break
    if blob is None:
        return None
    # blob: list of chains, each {param_name: [draws]}
    cols: dict[str, list] = {}
    for c in blob:
        for k, v in c.items():
            cols.setdefault(k, []).append(np.asarray(v, np.float64))
    cols = {k: np.concatenate(v) for k, v in cols.items()}

    if target_name == "eight_schools":
        mu = cols["mu"]
        tau = cols["tau"]
        thetas = np.stack(
            [cols[f"theta[{i+1}]"] for i in range(8)], axis=1
        )
        theta_base = (thetas - mu[:, None]) / tau[:, None]
        return np.concatenate(
            [mu[:, None], np.log(tau)[:, None], theta_base], axis=1
        ).astype(np.float32)
    if target_name == "diamonds":
        b = np.stack([cols[f"b[{i+1}]"] for i in range(24)], axis=1)
        return np.concatenate(
            [
                cols["Intercept"][:, None],
                b,
                np.log(cols["sigma"])[:, None],
            ],
            axis=1,
        ).astype(np.float32)
    if target_name == "kidiq":
        beta = np.stack([cols[f"beta[{i+1}]"] for i in range(3)], axis=1)
        return np.concatenate(
            [beta, np.log(cols["sigma"])[:, None]], axis=1
        ).astype(np.float32)
    return None


def vendored_gold_draws(target_name: str) -> Optional[np.ndarray]:
    """Vendored real gold-standard draws in comparison space
    (``models/_data``, copies of the JAX package's ``models/_gold``).

    diamonds: the PosteriorDB gold standard, 10k x 26 float32 in
    [Intercept, b(24), log(sigma)] layout; no other target is vendored."""
    p = DATA_DIR / f"{target_name}.npy"
    return np.load(p) if p.exists() else None


def get_reference_draws(
    target_name: str, n_draws: int = 10_000, **kw
) -> np.ndarray:
    ref = posteriordb_reference_draws(target_name)
    if ref is not None:
        return ref
    ref = vendored_gold_draws(target_name)
    if ref is not None:
        return ref
    return make_reference_draws(target_name, n_draws, **kw)


def ess_columns(samples: np.ndarray, fan_out: int = 1) -> np.ndarray:
    """Per-seed Geyer ESS across dims: (seeds, draws, dim) -> (seeds, dim).

    ``fan_out`` > 1 means each seed's draw axis interleaves F post-warmup
    clone chains frame-major (runner._per_seed), so the draws reshape to
    (frames, F, dim) and ESS treats the clones as chains — the standard
    multi-chain estimator (infer/diagnostics.py).  Runs on the CPU: a
    (seeds, draws, dim) array of draws."""
    from adaptive_mcmc_tpu_torch.infer.diagnostics import (
        effective_sample_size,
    )

    s, n, d = samples.shape
    f = max(1, int(fan_out))
    if n % f:
        f = 1
    x = torch.as_tensor(np.asarray(samples, np.float32)).reshape(
        s, n // f, f, d)
    # seeds ride along as parameters: (draws, chains, seeds, dim)
    ess = effective_sample_size(x.permute(1, 2, 0, 3)).numpy()
    # ESS cannot exceed the draw count; the estimator can overshoot on
    # slightly antithetic chains
    return np.minimum(ess, float(n))


def _wasserstein_worker(args):
    """Host-pool worker: exact 1-1 Wasserstein for one seed (cost matrix in
    numpy, assignment via the native/SciPy solver)."""
    x, y = args
    import scipy.spatial

    from adaptive_mcmc_tpu_torch.metrics.assignment import (
        linear_sum_assignment,
    )

    n = min(x.shape[0], y.shape[0])  # 1-1 coupling needs equal sizes
    cost = scipy.spatial.distance_matrix(x[:n], y[:n]).astype(np.float64)
    col = linear_sum_assignment(cost)
    return float(cost[np.arange(n), col].mean())


def _format(v, dtype) -> str:
    """A value as ``DataFrame.to_csv`` writes it: NaN empty, float64 by
    ``repr``, float32 by its own shortest repr."""
    if np.issubdtype(dtype, np.integer):
        return str(int(v))
    if np.isnan(v):
        return ""
    if dtype == np.float32:
        return str(np.float32(v))
    return repr(float(v))


def write_csv(table: dict, path) -> None:
    """``table`` (columns of equal length) in ``DataFrame.to_csv``'s layout:
    a leading unnamed index column."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    cols = [np.asarray(v) for v in table.values()]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(table))
        for i in range(len(cols[0]) if cols else 0):
            w.writerow([str(i)] + [_format(c[i], c.dtype) for c in cols])


@profiling.spanned("evaluate_run")
def evaluate_run(
    run_npz: str | Path,
    reference: np.ndarray,
    out_csv: Optional[str | Path] = None,
    *,
    n_workers: Optional[int] = None,
    exact_wasserstein_seeds: Optional[int] = None,
    exact_w_solver: str = "auction",
    exact_w_batch: int = 1,
    hungarian_check_seeds: int = 2,
    sinkhorn: bool = True,
    verbose: bool = False,
    checkpoint: Optional[str | Path] = None,
    device=None,
    timings: Optional[dict] = None,
) -> dict:
    """Per-seed metric rows for a saved w_eval run.  Returns a dict of
    numpy columns (``COLUMNS`` order) and writes the CSV if asked.

    Cost split: moment RMSE / MMD / Sinkhorn run on the device for every
    seed.  The exact 1-1 Wasserstein runs for the first
    ``exact_wasserstein_seeds`` seeds (None = all) with the selected
    solver:

    * ``"auction"`` (default) — the ε-auction on the device (mean assigned
      cost within ε_final ≈ range/(2n) of optimal).  The first
      ``hungarian_check_seeds`` seeds are ALSO solved with the exact host
      Hungarian and the two must agree to 2e-3 plus the auction's bound;
      with ``exact_w_batch`` B > 1 the check also covers seed B, the first
      warm-started batch's.  Each solve after the first warm-starts from
      the previous one's prices (one reference set for all seeds).
    * ``"host"`` — exact Hungarian for every covered seed (O(n³); a spawn
      process pool on multi-core hosts).

    ``checkpoint`` names a JSON side-file that persists the exact-W
    column after every solved batch, keyed by a cheap content signature
    of the npz: a killed eval resumes losing at most one batch of seeds.
    ``timings``, a dict, receives the seconds each metric column took
    (host clock closed by a synchronize)."""
    import concurrent.futures as cf
    import os
    import time

    from adaptive_mcmc_tpu_torch.experiments.runner import synchronize

    from adaptive_mcmc_tpu_torch.metrics.mmd import mmd_heuristic_many
    from adaptive_mcmc_tpu_torch.metrics.wasserstein import (
        wasserstein_dist11_p,
    )

    dev = run_device(device)
    with np.load(run_npz, allow_pickle=False) as data:
        samples = data["samples"]  # (seeds, draws, dim)
        meta = json.loads(str(data["meta"])) if "meta" in data else {}
    fan_out = int(meta.get("config", {}).get("fan_out", 1))
    S = samples.shape[0]
    y = torch.as_tensor(np.asarray(reference, np.float32), device=dev)

    ck_path = Path(checkpoint) if checkpoint is not None else None
    ck_sig = [
        list(int(v) for v in samples.shape),
        float(np.asarray(samples[:, 0], np.float64).sum()),
    ]
    wass_resume: list[float] = []
    if ck_path is not None and ck_path.exists():
        try:
            st = json.loads(ck_path.read_text())
            if st.get("sig") == ck_sig:
                wass_resume = [float(v) for v in st["wass"]]
                if verbose and wass_resume:
                    print(
                        f"  [wasserstein] resuming at seed "
                        f"{len(wass_resume)} from {ck_path.name}",
                        flush=True,
                    )
        except (ValueError, KeyError, TypeError):
            pass

    def _ck_save(wass: list[float]):
        if ck_path is not None:
            ck_path.parent.mkdir(parents=True, exist_ok=True)
            ck_path.write_text(json.dumps({"sig": ck_sig, "wass": wass}))

    @contextlib.contextmanager
    def _column(name: str):
        """One metric column: its span ``evaluate.<name>``, and its
        seconds in ``timings`` (host clock closed by a synchronize)."""
        with profiling.span(f"evaluate.{name}"):
            t0 = time.perf_counter()
            yield
            synchronize(dev)
            if timings is not None:
                timings[name] = time.perf_counter() - t0

    with _column("rmse_means"):
        xs = torch.as_tensor(np.asarray(samples, np.float32), device=dev)
        rmse = [float(pth_moment_rmse(x, y, p=1.0)) for x in xs]
    with _column("mmd"):
        mmd = [float(v) for v in mmd_heuristic_many(xs, y)]
    with _column("sinkhorn"):
        sk = [float(wasserstein_sinkhorn(xs[s], y)) if sinkhorn
              else float("nan") for s in range(S)]

    k = S if exact_wasserstein_seeds is None else min(
        S, exact_wasserstein_seeds
    )
    with _column("wasserstein"):
        if exact_w_solver == "auction":
            from adaptive_mcmc_tpu_torch.metrics.assignment import (
                auction_assignment_batch,
            )
            from adaptive_mcmc_tpu_torch.metrics.wasserstein import (
                minkowski_cost_matrix,
            )

            n_draws = min(samples.shape[1], reference.shape[0])
            y_dev = y[:n_draws]
            rows = torch.arange(n_draws, device=dev)
            B = max(1, int(exact_w_batch))

            def _check(s: int, w: float) -> None:
                # comparison noise + the auction's certified bound: mean
                # assigned cost is within eps_final = range/(2·n) of optimal,
                # which dominates at small n (tests) and vanishes at n=10k
                w_exact = _wasserstein_worker(
                    (np.asarray(samples[s], np.float64),
                     np.asarray(reference, np.float64))
                )
                pts = np.concatenate(
                    [samples[s, :n_draws], np.asarray(reference[:n_draws])]
                )
                span = float(np.linalg.norm(
                    np.max(pts, axis=0) - np.min(pts, axis=0)
                ))
                tol = 2e-3 * max(1.0, abs(w_exact)) + span / (2.0 * n_draws)
                if abs(w - w_exact) > tol:
                    raise AssertionError(
                        f"auction W {w:.6f} disagrees with exact Hungarian "
                        f"{w_exact:.6f} on seed {s}"
                    )

            prices = None  # warm-start duals: the same reference set per seed
            wass = list(wass_resume[:k])
            if B == 1:
                for s in range(len(wass), k):
                    w, prices = wasserstein_dist11_p(
                        xs[s, :n_draws], y_dev, solver="auction",
                        prices_init=prices, return_prices=True,
                    )
                    if s < hungarian_check_seeds:
                        _check(s, w)
                    wass.append(float(w))
                    _ck_save(wass)
                    if verbose and (s + 1) % 20 == 0:
                        print(f"  [wasserstein] seed {s+1}/{k}", flush=True)
            else:
                # batches after the first warm-start from the previous batch's
                # duals; the Hungarian check therefore also covers the first
                # warm-started seed (s == B), not just the cold batch
                for s0 in range(len(wass), k, B):
                    idx = list(range(s0, min(s0 + B, k)))
                    costs = torch.stack([
                        minkowski_cost_matrix(xs[s, :n_draws], y_dev)
                        for s in idx
                    ])
                    cols, prices = auction_assignment_batch(
                        costs, prices_init=prices, return_prices=True,
                    )
                    ws = [
                        float(torch.mean(costs[i, rows, cols[i]]))
                        for i in range(len(idx))
                    ]
                    del costs
                    for i, s in enumerate(idx):
                        if s < hungarian_check_seeds or s == B:
                            _check(s, ws[i])
                    wass.extend(ws)
                    _ck_save(wass)
                    if verbose:
                        print(f"  [wasserstein] seed {len(wass)}/{k}",
                              flush=True)
        else:
            y_np = np.asarray(reference, np.float64)
            jobs = [(np.asarray(samples[s], np.float64), y_np)
                    for s in range(k)]
            n_workers = n_workers or min(12, os.cpu_count() or 1)
            if n_workers > 1 and k > 1:
                import multiprocessing as mp

                # spawn (not fork): the parent holds a CUDA context; workers
                # only need numpy + the native solver
                with cf.ProcessPoolExecutor(
                    max_workers=n_workers, mp_context=mp.get_context("spawn")
                ) as pool:
                    wass = list(pool.map(_wasserstein_worker, jobs,
                                         chunksize=1))
            else:
                wass = []
                for i, j in enumerate(jobs):
                    wass.append(_wasserstein_worker(j))
                    if verbose:
                        print(f"  [wasserstein] seed {i+1}/{k}", flush=True)
        wass += [float("nan")] * (S - k)

    with _column("ess"):
        ess = ess_columns(samples, fan_out)  # (seeds, dim)
    table = {
        "rng_seed": np.arange(S),
        "rmse_means": np.asarray(rmse, np.float64),
        "wasserstein": np.asarray(wass, np.float64),
        "sinkhorn": np.asarray(sk, np.float64),
        "mmd": np.asarray(mmd, np.float64),
        "ess_median": np.median(ess, axis=1),
        "ess_min": np.min(ess, axis=1),
    }
    if out_csv is not None:
        write_csv(table, out_csv)
    return table

