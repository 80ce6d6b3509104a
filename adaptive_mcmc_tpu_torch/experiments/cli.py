"""Command-line entry points for the experiment harness (PyTorch).

    python -m adaptive_mcmc_tpu_torch.experiments.cli w_eval \
        --target eight_schools --kernel arwmh [--seeds 100] [--scale 0.1]
    python -m adaptive_mcmc_tpu_torch.experiments.cli lr_decay \
        --target eight_schools_centered --kernel arwmh [--n-pow 6] [--fused]
    python -m adaptive_mcmc_tpu_torch.experiments.cli evaluate \
        --target eight_schools --kernel arwmh
    python -m adaptive_mcmc_tpu_torch.experiments.cli summary \
        --target eight_schools --kernel nuts

w_eval over several devices, one process each (``--device cpu``: gloo):

    torchrun --nproc-per-node 2 -m adaptive_mcmc_tpu_torch.experiments.cli \
        w_eval --target eight_schools --kernel arwmh --mesh-devices 2

The commands, flags and ``--scale`` of ``adaptive_mcmc_tpu.experiments.cli``
(``--scale`` shrinks the reference iteration budgets proportionally for
smoke runs), plus ``--device``: every command runs on the card unless
``--device cpu`` is given, and ``--fused``: w_eval and lr_decay run ARWMH
through K2 and ASSS through K3 (``runner.build_kernel``).
"""

from __future__ import annotations

import argparse
import sys

from adaptive_mcmc_tpu_torch.experiments.configs import OUT_ROOT


def _scaled_budget(target: str, kernel: str, scale: float):
    from adaptive_mcmc_tpu_torch.experiments.configs import W_EVAL_BUDGETS

    b = dict(W_EVAL_BUDGETS[(target, kernel if kernel != "rwm" else "arwmh")])
    if scale != 1.0:
        b["num_warmup"] = max(1, int(b["num_warmup"] * scale))
        n_thin = max(1, int(b["num_samples"] * scale / b["thinning"]))
        b["num_samples"] = n_thin * b["thinning"]
    return b


def main(argv=None):
    p = argparse.ArgumentParser(prog="adaptive_mcmc_tpu_torch.experiments")
    p.add_argument("command",
                   choices=["w_eval", "lr_decay", "evaluate", "summary"])
    p.add_argument("--target", required=True)
    p.add_argument("--kernel", required=True)
    p.add_argument("--seeds", type=int, default=100)
    p.add_argument("--scale", type=float, default=1.0,
                   help="shrink reference iteration budgets by this factor")
    p.add_argument("--n-pow", type=int, default=6)
    p.add_argument("--lr-decay", type=float, default=2.0 / 3.0)
    p.add_argument("--out-dir", default=OUT_ROOT)
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="w_eval: split the chains over this many processes "
                        "(run under torchrun --nproc-per-node N)")
    p.add_argument("--ref-kernel", default="nuts",
                   help="kernel used to generate gold-standard draws when "
                        "PosteriorDB is unavailable (evaluate command)")
    p.add_argument("--ref-draws", type=int, default=10_000)
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: the CUDA card)")
    p.add_argument("--fused", action="store_const", const=True,
                   default=None,
                   help="w_eval / lr_decay: ARWMH through K2, ASSS through "
                        "K3 (default: the kernels' own pick)")
    args = p.parse_args(argv)

    if args.command == "w_eval":
        import torch.distributed as dist

        from adaptive_mcmc_tpu_torch.experiments.configs import RunConfig
        from adaptive_mcmc_tpu_torch.experiments.runner import run_w_eval
        from adaptive_mcmc_tpu_torch.parallel import initialize_distributed

        budget = _scaled_budget(args.target, args.kernel, args.scale)
        cfg = RunConfig(
            target=args.target, kernel=args.kernel, n_seeds=args.seeds,
            lr_decay=args.lr_decay, out_dir=args.out_dir,
            mesh_devices=args.mesh_devices, fused=args.fused, **budget,
        )
        # under torchrun (WORLD_SIZE > 1) every process joins the group
        joined = initialize_distributed(device=args.device) is not None
        try:
            run_w_eval(cfg, device=args.device)
        finally:
            if joined:
                dist.destroy_process_group()
    elif args.command == "lr_decay":
        from adaptive_mcmc_tpu_torch.experiments.runner import run_lr_decay

        run_lr_decay(
            args.target, args.kernel, n_pow=args.n_pow,
            n_seeds=args.seeds, out_dir=args.out_dir, device=args.device,
            fused=args.fused,
        )
    elif args.command == "evaluate":
        from pathlib import Path

        import numpy as np

        from adaptive_mcmc_tpu_torch.experiments.evaluate import (
            evaluate_run,
            get_reference_draws,
        )

        run_npz = Path(args.out_dir) / "w_eval" / args.target / (
            f"{args.kernel}.npz"
        )
        if not run_npz.exists():
            sys.exit(f"no run found at {run_npz}; run w_eval first")
        ref = get_reference_draws(
            args.target, args.ref_draws, kernel_name=args.ref_kernel,
            cache_dir=str(Path(args.out_dir) / "reference_draws"),
            device=args.device,
        )
        out_csv = run_npz.with_name(f"eval_{args.kernel}.csv")
        table = evaluate_run(run_npz, ref, out_csv, device=args.device)
        # DataFrame.describe's mean and std: NaN skipped, std with ddof 1
        names = list(table)
        width = max(len(n) for n in names) + 2
        print(" " * 5 + "".join(f"{n:>{width}}" for n in names))
        for row, fn in (("mean", np.nanmean),
                        ("std", lambda v: np.nanstd(v, ddof=1))):
            vals = [fn(np.asarray(table[n], np.float64))
                    if np.isfinite(table[n]).any() else float("nan")
                    for n in names]
            print(f"{row:<5}" + "".join(f"{v:>{width}.6g}" for v in vals))
        print(f"written {out_csv}")
    elif args.command == "summary":
        import torch

        from adaptive_mcmc_tpu_torch.experiments.runner import (
            TARGETS,
            build_kernel,
            run_device,
        )
        from adaptive_mcmc_tpu_torch.infer.mcmc import MCMC

        dev = run_device(args.device)
        target = TARGETS[args.target]()
        kernel = build_kernel(
            args.kernel, target, lr_decay=args.lr_decay, num_warmup=1000
        )
        mcmc = MCMC(kernel, num_warmup=1000,
                    num_samples=max(1000, int(10000 * args.scale)),
                    thinning=1, n_chains=8)
        mcmc.run(torch.Generator(dev).manual_seed(0))
        print(mcmc.diagnostics_str())
        mcmc.print_summary()


if __name__ == "__main__":
    main()
