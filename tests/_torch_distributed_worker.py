"""One process of the port's multi-process CPU tests
(tests/test_torch_distributed.py): gloo over a ``file://`` rendezvous.

Usage: python tests/_torch_distributed_worker.py <scenario> <rank> <world>
       <init_method> <out_dir>

Each scenario runs the port's parallel layer on this process's block and
saves what the test compares, with torch.save, to
``<out_dir>/<scenario>_<rank>.pt``.  The tests hold it against one-process
runs (which they make themselves) and against the JAX package; this
process imports neither jax nor adaptive_mcmc_tpu.

* ``core`` (2 processes): the all-reduce of [0, 1, 2, 3]; chain_mesh(2) in
  the gloo group, a sub-mesh of 1, chain_sharding, replicated; the gathered
  run_mcmc_sharded draws of ARWMH, ASSS, NUTS and SA; a fan-out; sharded
  sample_pnx (ASSS from a seed, ARWMH from a generator); the collectives;
  the collectives a run makes; run_w_eval on the mesh, twice.
* ``scale`` (4 processes): the collectives, the collectives a run makes.
* ``one`` (1 process, a group of one): run_mcmc_sharded on chain_mesh()
  for ARWMH and ASSS, and the collectives a run makes.
"""

import dataclasses
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.infer.mcmc import (  # noqa: E402
    get_init_adapt_state,
    sample_pnx,
)
from adaptive_mcmc_tpu_torch.parallel import (  # noqa: E402
    chain_mesh,
    chain_sharding,
    cross_chain_moments,
    initialize_distributed,
    replicated,
    run_mcmc_sharded,
    sharded_gelman_rubin,
)

CPU = torch.device("cpu")
# the budgets of the sharded runs: (num_warmup, num_samples, thinning)
RUN = (6, 12, 3)
N_CHAINS = 8
SEED = 7
# sample_pnx's grid: points x samples, padded to a multiple of the mesh
PNX_POINTS, PNX_SAMPLES, PNX_STEPS = 3, 5, 3
# the collectives' inputs, made from these numpy seeds
MOMENTS_SHAPE, RHAT_SHAPE = (64, 3), (200, 16, 3)
# the step counts whose runs must make the same collectives
COUNT_RUNS = ((4, 8), (40, 80))


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def build(name: str):
    t = amt.eight_schools_noncentered()
    if name == "arwmh":
        return amt.arwmh(t, amt.ARWMHConfig(num_warmup=RUN[0]))
    if name == "asss":
        return amt.asss(t, amt.ASSSConfig(num_warmup=RUN[0]))
    if name == "nuts":
        return amt.nuts(t, amt.NUTSConfig(num_warmup=RUN[0],
                                          max_tree_depth=3))
    return amt.sa(t, amt.SAConfig(num_warmup=RUN[0]))


def moments_input() -> np.ndarray:
    return np.random.default_rng(3).normal(0.5, 1.5, size=MOMENTS_SHAPE) \
        .astype(np.float32)


def rhat_input() -> np.ndarray:
    rng = np.random.default_rng(4)
    return (rng.normal(size=RHAT_SHAPE)
            + rng.normal(0, 0.3, size=(1,) + RHAT_SHAPE[1:])) \
        .astype(np.float32)


def pnx_input(kernel, seed: int):
    """(probe points, adapt state of one leaf row per point)."""
    x = np.random.default_rng(seed).normal(size=(PNX_POINTS, 10)) \
        .astype(np.float32)
    adapt = get_init_adapt_state(kernel, gen(seed), n_chains=PNX_POINTS)
    return torch.from_numpy(x), adapt


def collectives(mesh) -> dict:
    x = torch.from_numpy(moments_input())[chain_sharding(mesh,
                                                         MOMENTS_SHAPE[0])]
    y = torch.from_numpy(rhat_input())[:, chain_sharding(mesh,
                                                         RHAT_SHAPE[1])]
    mean, var = cross_chain_moments(x, mesh)
    return {"mean": mean, "var": var, "rhat": sharded_gelman_rubin(y, mesh)}


def count_collectives(mesh) -> dict:
    """The all-reduces of an ARWMH run_mcmc_sharded at each of COUNT_RUNS,
    and how many of them ran inside a kernel step."""
    calls = {"n": 0, "in_step": 0, "stepping": False}
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls["n"] += 1
        calls["in_step"] += calls["stepping"]
        return all_reduce(*args, **kwargs)

    kernel = build("arwmh")
    step = kernel.step

    def watched(state, generator, *args, **kwargs):
        calls["stepping"] = True
        try:
            return step(state, generator, *args, **kwargs)
        finally:
            calls["stepping"] = False

    kernel = dataclasses.replace(kernel, step=watched)
    out = {}
    dist.all_reduce = counted
    try:
        for warm, samples in COUNT_RUNS:
            calls["n"] = 0
            run_mcmc_sharded(kernel, gen(SEED), warm, samples, thinning=4,
                             n_chains=4 * mesh.size, mesh=mesh,
                             extra_fields=("potential_energy",))
            out[warm + samples] = calls["n"]
    finally:
        dist.all_reduce = all_reduce
    out["in_step"] = calls["in_step"]
    return out


def sharded_runs(mesh, names) -> dict:
    out = {}
    for name in names:
        samples, extras, last = run_mcmc_sharded(
            build(name), gen(SEED), *RUN[:2], thinning=RUN[2],
            n_chains=N_CHAINS, mesh=mesh, extra_fields=("potential_energy",))
        out[name] = {"samples": samples,
                     "potential_energy": extras["potential_energy"],
                     "last": last.position}
    return out


def run_w_eval_twice(mesh, out_dir: Path) -> dict:
    """run_w_eval on the mesh, counting this process's npz writes; then
    again, when every process must skip."""
    from adaptive_mcmc_tpu_torch.experiments.configs import RunConfig
    from adaptive_mcmc_tpu_torch.experiments.runner import run_w_eval

    cfg = RunConfig(target="eight_schools", kernel="arwmh", num_warmup=20,
                    num_samples=40, thinning=4, n_seeds=5,
                    out_dir=str(out_dir / "runs"), mesh_devices=mesh.size)
    writes = []
    savez = np.savez_compressed

    def counted(path, **arrays):
        writes.append(str(path))
        return savez(path, **arrays)

    np.savez_compressed = counted
    try:
        first = run_w_eval(cfg, verbose=False, device="cpu")
        second = run_w_eval(cfg, verbose=False, device="cpu")
    finally:
        np.savez_compressed = savez
    return {"writes": writes, "paths": [str(first), str(second)]}


def core(rank: int, out_dir: Path) -> dict:
    res = {}
    total = torch.arange(2, dtype=torch.float32) + 2 * rank
    total = total.sum()
    dist.all_reduce(total)
    res["total"] = float(total)
    mesh = chain_mesh(devices=["cpu"])
    res["mesh"] = (mesh.size, mesh.rank, mesh.member,
                   mesh.group is dist.group.WORLD, str(mesh.device))
    sub = chain_mesh(1, devices=["cpu"])
    res["sub"] = (sub.size, sub.rank, sub.member, sub.group)
    res["sharding"] = chain_sharding(mesh, N_CHAINS)
    res["replicated"] = str(replicated(mesh))
    try:
        chain_mesh(3, devices=["cpu"])
        res["mesh_of_3"] = "built"
    except ValueError as e:
        res["mesh_of_3"] = str(e)
    res["runs"] = sharded_runs(mesh, ("arwmh", "asss", "nuts", "sa"))
    res["fan"], _, _ = run_mcmc_sharded(
        amt.arwmh(amt.std_normal(3), amt.ARWMHConfig(num_warmup=0)), gen(1),
        8, 64, thinning=2, n_chains=4, fan_out=4, mesh=mesh)
    k = amt.asss(amt.eight_schools_noncentered())
    x, adapt = pnx_input(k, 11)
    res["pnx_asss"] = sample_pnx(k, 11, x, adapt, n=PNX_STEPS,
                                 n_samples=PNX_SAMPLES, mesh=mesh)
    k = amt.arwmh(amt.eight_schools_noncentered())
    x, adapt = pnx_input(k, 12)
    g = gen(12)
    res["pnx_arwmh"] = sample_pnx(k, g, x, adapt, n=PNX_STEPS,
                                  n_samples=PNX_SAMPLES, mesh=mesh)
    res["pnx_generator_after"] = g.get_state()
    res["collectives"] = collectives(mesh)
    res["counts"] = count_collectives(mesh)
    res["w_eval"] = run_w_eval_twice(mesh, out_dir)
    return res


def scale(rank: int, out_dir: Path) -> dict:
    mesh = chain_mesh(devices=["cpu"])
    return {"collectives": collectives(mesh),
            "counts": count_collectives(mesh)}


def one(rank: int, out_dir: Path) -> dict:
    mesh = chain_mesh(devices=["cpu"])
    return {"mesh": (mesh.size, mesh.group is dist.group.WORLD),
            "runs": sharded_runs(mesh, ("arwmh", "asss")),
            "counts": count_collectives(mesh)}


def main() -> None:
    scenario, rank, world, init_method, out_dir = sys.argv[1:6]
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=60))
    try:
        res = {"core": core, "scale": scale, "one": one}[scenario](
            rank, out_dir)
        torch.save(res, out_dir / f"{scenario}_{rank}.pt")
        # nobody leaves the group while another still reduces
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"worker {rank} ok", flush=True)


if __name__ == "__main__":
    main()
