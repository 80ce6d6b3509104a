#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adaptive_mcmc_tpu_torch) once on an NVIDIA
GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels from csrc/ at first use.
Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, the nvcc build time of both kernels;
2. K1 (csrc/chol_update.cu) against its plain PyTorch version on the card at
   (C, d) = (4096, 10), (1024, 26), (37, 5) and every d from 1 to 32, the
   NaN of an indefinite downdate, strict triangularity; card times of
   kernel and plain version at (4096, 10) (CUDA events around CUDA-graph
   replays);
3. K2 (csrc/arwmh_fused.cu) against its plain version on injected draws at
   C = 4096, d = 10, 16 steps with frames; times of both;
4. the main path: MCMC(arwmh(eight_schools_noncentered()), num_warmup=5000,
   num_samples=20000, thinning=10, n_chains=4096).run(...) with the lockstep
   step (through K1) and with ARWMHConfig(fused=True) (through K2):
   posterior checks, launch counts and chain-iters/s;
5. one JSON line of kernel results, then the contract line last.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

K1_TOL = 1e-5                 # the tolerance of the Pallas parity tests
K2_RTOL, K2_ATOL = 2e-5, 2e-6
N_CHAINS, NUM_WARMUP, NUM_SAMPLES, THINNING = 4096, 5000, 20000, 10


def require(ok, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def device_ms(fn, reps: int, replays: int = 5) -> float:
    """Milliseconds of card time per call of ``fn``: CUDA events around
    replays of a CUDA graph that holds ``reps`` calls, so the host's launch
    cost stays out of the window (a call of the eager plain versions costs
    the host far more than the card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm call outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def chol_inputs(C: int, d: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(C, d, d)) * 0.4
    L = np.linalg.cholesky(np.einsum("cij,ckj->cik", a, a) + np.eye(d))
    Lt = torch.tensor(L.transpose(1, 2, 0), dtype=torch.float32, device=dev)
    vt = torch.tensor(rng.normal(size=(d, C)), dtype=torch.float32,
                      device=dev)
    coef = torch.tensor(np.linspace(0.01, 0.9, C), dtype=torch.float32,
                        device=dev)
    return Lt.contiguous(), vt, coef


def check_k1(k1, dev) -> dict:
    worst = 0.0
    main_shapes = [(4096, 10), (1024, 26), (37, 5)]
    for C, d in main_shapes + [(37, d) for d in range(1, 33) if d != 5]:
        Lt, vt, coef = chol_inputs(C, d, seed=C + d, dev=dev)
        got = k1.chol_update_cl(Lt, vt, coef)
        want = k1.chol_update_cl_reference(Lt, vt, coef)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err <= K1_TOL, f"K1 disagrees at C={C} d={d}: {err}")
        upper = torch.triu(got.permute(2, 0, 1), diagonal=1)
        require(bool((upper == 0).all()), f"K1 not triangular at d={d}")
        require(bool((torch.diagonal(got, 0, 0, 1) > 0).all()),
                f"K1 diagonal not positive at d={d}")
        worst = max(worst, err)
        if (C, d) in main_shapes:
            print(f"K1 C={C} d={d}: max_abs_err={err:.3e}")
    # an indefinite downdate gives NaN where the plain version does
    d, C = 4, 128
    Lt = torch.eye(d, device=dev)[:, :, None].expand(d, d, C).contiguous()
    vt = torch.zeros((d, C), device=dev)
    vt[0] = 10.0
    coef = torch.full((C,), -1.0, device=dev)
    got = k1.chol_update_cl(Lt, vt, coef)
    want = k1.chol_update_cl_reference(Lt, vt, coef)
    require(bool(torch.isnan(got).any()), "K1 downdate gave no NaN")
    require(torch.equal(torch.isnan(got), torch.isnan(want)),
            "K1 NaN pattern differs from the plain version")
    Lt, vt, coef = chol_inputs(4096, 10, seed=0, dev=dev)
    ms = device_ms(lambda: k1.chol_update_cl(Lt, vt, coef), 100)
    plain_ms = device_ms(
        lambda: k1.chol_update_cl_reference(Lt, vt, coef), 10)
    print(f"K1 (4096, 10): kernel {ms:.6f} ms, plain {plain_ms:.6f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_k2(amt, k2, dev) -> dict:
    t = amt.eight_schools_noncentered()
    cfg = amt.ARWMHConfig(num_warmup=4)
    C, S, d = N_CHAINS, 16, t.dim
    g = torch.Generator(dev).manual_seed(123)
    x = torch.rand((C, d), generator=g, device=dev) * 4 - 2
    state = (x, t.potential_fn(x), torch.zeros(C, device=dev), x.clone(),
             torch.eye(d, device=dev).expand(C, d, d).contiguous(),
             torch.zeros(C, device=dev), 0)
    noise = torch.randn((S, C, d), generator=g, device=dev)
    unif = torch.rand((S, C), generator=g, device=dev)
    drive = k2.build_fused_arwmh(t, cfg)

    def kernel():
        return drive(state, S, 4, 4, noise=noise, unif=unif)

    def plain():
        return k2.fused_arwmh_reference(t, cfg, state, S, 4, 4,
                                        noise=noise, unif=unif)

    (got, gf), (want, wf) = kernel(), plain()
    torch.cuda.synchronize()
    require(int(got[6]) == int(want[6]) == S, "K2 step counter")
    pairs = list(zip(got[:6], want[:6])) + [(got[7], want[7])] \
        + [(gf[k], wf[k]) for k in wf]
    worst = 0.0
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=K2_RTOL, atol=K2_ATOL)
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    moved = (got[0] != state[0]).any(dim=1).float().mean()
    print(f"K2 C={C} d={d} S={S}: max_abs_err={worst:.3e}, "
          f"chains moved {float(moved):.3f}")
    ms = device_ms(kernel, 10)
    plain_ms = device_ms(plain, 1)
    print(f"K2 (4096, d=10, 16 steps): kernel {ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def run_main_path(amt, fused: bool, card: str) -> float:
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.arwmh(t, amt.ARWMHConfig(fused=fused)),
                    num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
                    thinning=THINNING, n_chains=N_CHAINS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcmc.run(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mcmc.print_summary()
    print(mcmc.diagnostics_str())
    draws = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    require(draws.is_cuda, "draws not on the card")
    require(tuple(draws.shape) == (NUM_SAMPLES // THINNING, N_CHAINS, t.dim),
            f"draws shape {tuple(draws.shape)}")
    require(bool(torch.isfinite(draws).all()), "non-finite draws")
    sites = mcmc.get_samples()
    mu_mean = float(sites["mu"].mean())
    tau_median = float(sites["tau"].median())
    accept = float(mcmc.last_state.mean_accept_prob.mean())
    name = "fused (K2)" if fused else "lockstep (K1)"
    rate = N_CHAINS * (NUM_WARMUP + NUM_SAMPLES) / wall
    print(f"main path {name}: mu mean {mu_mean:.4f}, tau median "
          f"{tau_median:.4f}, mean acceptance {accept:.4f}")
    print(f"main path {name}: {rate:.1f} chain-iters/s "
          f"({N_CHAINS} chains x {NUM_WARMUP + NUM_SAMPLES} steps in "
          f"{wall:.3f} s, build excluded) on {card}")
    require(0.15 < accept < 0.35, f"mean acceptance {accept}")
    require(abs(mu_mean - 4.4) < 0.3, f"mu mean {mu_mean}")
    require(abs(tau_median - 2.9) < 0.4, f"tau median {tau_median}")
    return rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import adaptive_mcmc_tpu_torch as amt
    from adaptive_mcmc_tpu_torch.ops.cuda import _build
    from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused as k2
    from adaptive_mcmc_tpu_torch.ops.cuda import chol_update as k1

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    for name in ("chol_update", "arwmh_fused"):
        t0 = time.perf_counter()
        _build.load(name)
        print(f"build {name}: {time.perf_counter() - t0:.3f} s "
              f"(nvcc {_build.build_seconds.get(name, 0.0):.3f} s)")

    # 2.-3. kernels against their plain versions
    k1_res = check_k1(k1, dev)
    k2_res = check_k2(amt, k2, dev)

    # 4. the main path, through the kernels
    k1.launches = 0
    k2.launches = 0
    lock_rate = run_main_path(amt, fused=False, card=card)
    k1_main = k1.launches
    fused_rate = run_main_path(amt, fused=True, card=card)
    k2_main = k2.launches
    print(f"launches on the main path: chol_update {k1_main}, "
          f"arwmh_fused {k2_main}")
    require(k1_main > 0, "the lockstep main path never launched K1")
    require(k2_main > 0, "the fused main path never launched K2")
    print(f"chain-iters/s: lockstep {lock_rate:.1f}, fused "
          f"{fused_rate:.1f} on {card}")

    # 5. results
    kernels = [
        dict(name="chol_update", route="cuda",
             source="adaptive_mcmc_tpu_torch/csrc/chol_update.cu",
             replaces="adaptive_mcmc_tpu/ops/pallas/chol_update.py:107",
             launches=k1_main, **k1_res),
        dict(name="arwmh_fused", route="cuda",
             source="adaptive_mcmc_tpu_torch/csrc/arwmh_fused.cu",
             replaces="adaptive_mcmc_tpu/ops/pallas/arwmh_fused.py:426",
             launches=k2_main, **k2_res),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
