#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adaptive_mcmc_tpu_torch) once on an NVIDIA
GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the three kernels from csrc/ at the
start, one nvcc process each, all at once.  Phases, in order; any failure
ends the run with a non-zero exit:

1. device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, the nvcc build times;
2. K1 (csrc/chol_update.cu) against its plain PyTorch version on the card at
   (C, d) = (4096, 10), (1024, 26), (37, 5) and every d from 1 to 32, the
   NaN of an indefinite downdate, strict triangularity; card times of
   kernel and plain version at (4096, 10) (CUDA events around CUDA-graph
   replays);
3. K2 (csrc/arwmh_fused.cu) against its plain version on injected draws at
   C = 4096, d = 10, 16 steps with frames; times of both;
4. K3 (csrc/asss_fused.cu) against its plain version on injected draws at
   C = 4096, d = 10, 16 steps with 4 frames at thinning 4: every field and
   frame, and each chain's iteration count exactly; times of both; the
   bail-out (max_shrinkage_iters=0 stays put bit for bit);
5. the ARWMH main path: MCMC(arwmh(eight_schools_noncentered()),
   num_warmup=5000, num_samples=20000, thinning=10, n_chains=4096) with the
   lockstep step (through K1) and with ARWMHConfig(fused=True) (through K2);
6. the ASSS main path: the same MCMC call with
   asss(..., ASSSConfig(fused=True)) (through K3), and the µs per step of a
   long step_n; then the lockstep step and the pipelined step_n (both
   through K1) for 500 + 1500 steps from fresh positions under the adapted
   scale of the K3 run;
   every path: posterior bands, launch counts (all counts set to 0 just
   before the path and read just after it) and chain-iters/s;
7. one JSON line of kernel results, then the contract line last.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

K1_TOL = 1e-5                 # the tolerance of the Pallas parity tests
K2_RTOL, K2_ATOL = 2e-5, 2e-6
# tighter than test_pallas.py's 2e-4 / 2e-5 for the JAX K3: the kernel and
# its plain version round alike
K3_RTOL, K3_ATOL = 2e-5, 2e-6
N_CHAINS, NUM_WARMUP, NUM_SAMPLES, THINNING = 4096, 5000, 20000, 10
K1_ASSS_WARMUP, K1_ASSS_SAMPLES = 500, 1500
KERNELS = ("chol_update", "arwmh_fused", "asss_fused")


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


def check_k3(amt, k3, dev) -> dict:
    t = amt.eight_schools_noncentered()
    cfg = amt.ASSSConfig(num_warmup=8)
    C, n_steps, F, thin, d = N_CHAINS, 16, 4, 4, t.dim
    g = torch.Generator(dev).manual_seed(321)
    x = torch.rand((C, d), generator=g, device=dev) * 4 - 2
    state = (x, t.potential_fn(x), x.clone(),
             torch.eye(d, device=dev).expand(C, d, d).contiguous(), 0,
             torch.zeros(C, device=dev))
    rows = 1024
    unif3 = torch.rand((rows, 3, C), generator=g, device=dev) \
        .clamp_(1e-6, 1 - 1e-6)
    n01 = torch.randn((rows, d + 1, C), generator=g, device=dev)
    drive = k3.build_fused_asss(t, cfg)
    _, _, iters0 = drive(state, n_steps, F, thin, unif3=unif3, n01=n01,
                         return_iters=True)
    used = int(iters0.max())
    require(used <= rows, f"K3 ran {used} iterations past {rows} draw rows")
    # time and compare on exactly the rows the longest chain used
    u3, nn = unif3[:used].contiguous(), n01[:used].contiguous()

    def kernel():
        return drive(state, n_steps, F, thin, unif3=u3, n01=nn,
                     return_iters=True)

    def plain():
        return k3.fused_asss_reference(t, cfg, state, n_steps, F, thin,
                                       unif3=u3, n01=nn, return_iters=True)

    (got, gf, gi), (want, wf, wi) = kernel(), plain()
    torch.cuda.synchronize()
    require(torch.equal(gi, wi) and torch.equal(gi, iters0),
            "K3 iteration counts differ from the plain version's")
    require(int(got[4]) == int(want[4]) == n_steps, "K3 step counter")
    pairs = [(got[k], want[k]) for k in (0, 1, 2, 3, 5)] \
        + [(gf[k], wf[k]) for k in wf]
    worst = 0.0
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=K3_RTOL, atol=K3_ATOL)
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    require(torch.equal(gf["position"][:, -1], got[0]),
            "K3 last frame is not the final state")
    moved = (got[0] != state[0]).any(dim=1).float().mean()
    print(f"K3 C={C} d={d} {n_steps} steps: max_abs_err={worst:.3e}, "
          f"iterations per chain {float(gi.float().mean()):.2f} mean, "
          f"{int(gi.min())}..{used}, chains moved {float(moved):.3f}")
    ms = device_ms(kernel, 10)
    plain_ms = device_ms(plain, 1)
    print(f"K3 (4096, d=10, 16 steps, {used} draw rows): kernel {ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms")

    # bail-out: with max_shrinkage_iters=0 every transition stays put
    bail = k3.build_fused_asss(t, amt.ASSSConfig(max_shrinkage_iters=0))
    out, frames, iters = bail(state, 8, 2, 4, generator=g,
                              return_iters=True)
    torch.cuda.synchronize()
    require(torch.equal(out[0], state[0]) and torch.equal(out[1], state[1]),
            "K3 bail-out moved a chain")
    require(torch.equal(frames["position"][:, -1], state[0]),
            "K3 bail-out frame")
    require(int(out[4]) == 8 and bool((iters == 9).all()),
            "K3 bail-out step or iteration count")
    print("K3 bail-out: positions unchanged bit for bit, i advanced by 8")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def reset_launches(*modules) -> None:
    for m in modules:
        m.launches = 0


def eight_schools_bands(name: str, sites) -> None:
    mu_mean = float(sites["mu"].mean())
    tau_median = float(sites["tau"].median())
    print(f"{name}: mu mean {mu_mean:.4f}, tau median {tau_median:.4f}")
    require(abs(mu_mean - 4.4) < 0.3, f"{name}: mu mean {mu_mean}")
    require(abs(tau_median - 2.9) < 0.4, f"{name}: tau median {tau_median}")


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
    accept = float(mcmc.last_state.mean_accept_prob.mean())
    name = "ARWMH fused (K2)" if fused else "ARWMH lockstep (K1)"
    rate = N_CHAINS * (NUM_WARMUP + NUM_SAMPLES) / wall
    eight_schools_bands(name, mcmc.get_samples())
    print(f"{name}: mean acceptance {accept:.4f}")
    print(f"{name}: {rate:.1f} chain-iters/s ({N_CHAINS} chains x "
          f"{NUM_WARMUP + NUM_SAMPLES} steps in {wall:.3f} s, build "
          f"excluded) on {card}")
    require(0.15 < accept < 0.35, f"mean acceptance {accept}")
    return rate


def run_asss_fused(amt, card: str):
    """The ASSS main path through K3; returns (rate, last state)."""
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.asss(t, amt.ASSSConfig(fused=True)),
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
    require(draws.is_cuda, "ASSS draws not on the card")
    require(tuple(draws.shape) == (NUM_SAMPLES // THINNING, N_CHAINS, t.dim),
            f"ASSS draws shape {tuple(draws.shape)}")
    require(bool(torch.isfinite(draws).all()), "non-finite ASSS draws")
    name = "ASSS fused (K3)"
    eight_schools_bands(name, mcmc.get_samples())
    rate = N_CHAINS * (NUM_WARMUP + NUM_SAMPLES) / wall
    print(f"{name}: {rate:.1f} chain-iters/s ({N_CHAINS} chains x "
          f"{NUM_WARMUP + NUM_SAMPLES} steps in {wall:.3f} s, build "
          f"excluded) on {card}")
    return rate, mcmc.last_state


def step_n_us(kernel, state, n_steps: int, card: str) -> float:
    """µs per step of one long production-mode step_n (CUDA events)."""
    g = torch.Generator("cuda").manual_seed(7)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = kernel.step_n(state, n_steps, g)
    end.record()
    end.synchronize()
    require(int(out.i) == int(state.i) + n_steps, "step_n step counter")
    us = start.elapsed_time(end) * 1000.0 / n_steps
    print(f"ASSS fused (K3) step_n of {n_steps} steps at {N_CHAINS} chains: "
          f"{us:.4f} µs per step on {card}")
    return us


def run_asss_k1(amt, adapted, lockstep: bool, card: str) -> float:
    """An ASSS driver through K1 (the lockstep step, or the pipelined
    step_n), from fresh positions under the adapted (loc, scale) of the K3
    run, its adaptation clock continuing from that run's."""
    t = amt.eight_schools_noncentered()
    kernel = amt.asss(t)
    if lockstep:
        kernel = dataclasses.replace(kernel, step_n=None, collect_n=None)
    name = "ASSS lockstep (K1)" if lockstep else "ASSS pipelined (K1)"
    g = torch.Generator("cuda").manual_seed(1 if lockstep else 2)
    start = kernel.init(g, n_chains=N_CHAINS,
                        adapt_state=adapted.adapt_state)._replace(i=adapted.i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, _, last = amt.run_mcmc(
        kernel, g, K1_ASSS_WARMUP, K1_ASSS_SAMPLES, thinning=THINNING,
        n_chains=N_CHAINS, init_state=start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(samples.is_cuda and bool(torch.isfinite(samples).all()),
            f"{name}: draws not finite on the card")
    moved = float((last.position != start.position).any(dim=1).float()
                  .mean())
    require(moved > 0.99, f"{name}: only {moved} of the chains moved")
    eight_schools_bands(name, t.constrain(samples))
    steps = K1_ASSS_WARMUP + K1_ASSS_SAMPLES
    rate = N_CHAINS * steps / wall
    print(f"{name}: {rate:.1f} chain-iters/s ({N_CHAINS} chains x {steps} "
          f"steps in {wall:.3f} s) on {card}")
    return rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import adaptive_mcmc_tpu_torch as amt
    from adaptive_mcmc_tpu_torch.ops.cuda import _build
    from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused as k2
    from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3
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
    t0 = time.perf_counter()
    _build.build(*KERNELS)
    print(f"build {', '.join(KERNELS)}: {time.perf_counter() - t0:.3f} s "
          f"in parallel (nvcc " + ", ".join(
              f"{n} {_build.build_seconds.get(n, 0.0):.3f} s"
              for n in KERNELS) + ")")
    for name in KERNELS:
        _build.load(name)

    # 2.-4. kernels against their plain versions
    k1_res = check_k1(k1, dev)
    k2_res = check_k2(amt, k2, dev)
    k3_res = check_k3(amt, k3, dev)
    counters = (k1, k2, k3)

    # 5. the ARWMH main path, through K1 and K2
    reset_launches(*counters)
    lock_rate = run_main_path(amt, fused=False, card=card)
    k1_main = k1.launches
    reset_launches(*counters)
    fused_rate = run_main_path(amt, fused=True, card=card)
    k2_main = k2.launches
    print(f"launches: ARWMH lockstep chol_update {k1_main}, ARWMH fused "
          f"arwmh_fused {k2_main}")
    require(k1_main > 0, "the lockstep ARWMH path never launched K1")
    require(k2_main > 0, "the fused ARWMH path never launched K2")

    # 6. the ASSS main path through K3, then the ASSS drivers through K1
    reset_launches(*counters)
    asss_rate, asss_last = run_asss_fused(amt, card)
    k3_main = k3.launches
    require(k3_main > 0, "the ASSS main path never launched K3")
    k3_us = step_n_us(amt.asss(amt.eight_schools_noncentered(),
                               amt.ASSSConfig(fused=True)),
                      asss_last, NUM_WARMUP, card)
    k1_asss = {}
    for lockstep in (True, False):
        reset_launches(*counters)
        rate = run_asss_k1(amt, asss_last, lockstep, card)
        k1_asss[lockstep] = (rate, k1.launches)
        require(k1.launches > 0, "an ASSS driver never launched K1")
    print(f"launches: ASSS fused asss_fused {k3_main}, ASSS lockstep "
          f"chol_update {k1_asss[True][1]}, ASSS pipelined chol_update "
          f"{k1_asss[False][1]}")
    print(f"chain-iters/s on {card}: ARWMH lockstep {lock_rate:.1f}, ARWMH "
          f"fused {fused_rate:.1f}, ASSS fused {asss_rate:.1f} "
          f"({k3_us:.4f} µs per step in step_n), ASSS lockstep "
          f"{k1_asss[True][0]:.1f}, ASSS pipelined {k1_asss[False][0]:.1f}")

    # 7. results
    kernels = [
        dict(name="chol_update", route="cuda",
             source="adaptive_mcmc_tpu_torch/csrc/chol_update.cu",
             replaces="adaptive_mcmc_tpu/ops/pallas/chol_update.py:107",
             launches=k1_main, **k1_res),
        dict(name="arwmh_fused", route="cuda",
             source="adaptive_mcmc_tpu_torch/csrc/arwmh_fused.cu",
             replaces="adaptive_mcmc_tpu/ops/pallas/arwmh_fused.py:426",
             launches=k2_main, **k2_res),
        dict(name="asss_fused", route="cuda",
             source="adaptive_mcmc_tpu_torch/csrc/asss_fused.cu",
             replaces="adaptive_mcmc_tpu/ops/pallas/asss_fused.py:526",
             launches=k3_main, **k3_res),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
