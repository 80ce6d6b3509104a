"""The port's chain mesh over several processes (adaptive_mcmc_tpu_torch
.parallel on torch.distributed), on the CPU: gloo over a ``file://``
rendezvous, each process started by ``entry.run_workers`` with its own
timeout (a process that hangs fails its test in 120 s, and a collective
waits 60 s for a lost peer).

tests/_torch_distributed_worker.py runs the scenarios; this file makes the
one-process runs they are held against and runs the JAX package's
collectives on its 8-device CPU mesh:

* the 2-process all-reduce of [0, 1, 2, 3] (tests/_distributed_worker.py's
  check for JAX) and chain_mesh(2) in the gloo group;
* the gathered run_mcmc_sharded draws of ARWMH, ASSS, NUTS and SA equal,
  bit for bit, the concatenated one-process runs of the two blocks from
  the ranks' generators; a one-rank mesh equals the one-process driver;
  fan-out clones differ across ranks;
* cross_chain_moments and sharded_gelman_rubin at 2 and 4 processes
  against JAX's at rtol 1e-5;
* a run makes the same collectives (one all-reduce per gathered field, 0
  on one rank) at 1, 2 and 4 processes whatever its step count, and none
  inside a step (the counterpart of JAX's flat per-device cost);
* sample_pnx(mesh=) equals the ranks' one-process rollouts, the padding
  dropped;
* run_w_eval on 2 processes writes one npz, from rank 0, without the
  padded chain, and both skip the complete cell;
* dryrun_multichip(4, device="cpu") prints JAX's ok line."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu import parallel as jpar  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.entry import (  # noqa: E402
    dryrun_multichip,
    run_workers,
)
from adaptive_mcmc_tpu_torch.infer.mcmc import (  # noqa: E402
    map_state,
    sample_pnx,
)
from adaptive_mcmc_tpu_torch.parallel import (  # noqa: E402
    rank_generator,
    rank_seed,
    run_mcmc_sharded,
)

WORKER = Path(__file__).resolve().parent / "_torch_distributed_worker.py"
_spec = importlib.util.spec_from_file_location("_torch_dist_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
TIMEOUT = 120.0


def _launch(out: Path, scenario: str, n: int) -> list:
    run_workers(lambda r: [str(WORKER), scenario, str(r), str(n),
                           f"file://{out}/rendezvous_{scenario}", str(out)],
                n, TIMEOUT, f"the {scenario} scenario")
    return [torch.load(out / f"{scenario}_{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("distributed")


@pytest.fixture(scope="module")
def core(out_dir):
    return _launch(out_dir, "core", 2)


@pytest.fixture(scope="module")
def scale(out_dir):
    return _launch(out_dir, "scale", 4)


@pytest.fixture(scope="module")
def one(out_dir):
    return _launch(out_dir, "one", 1)


def _twins(name: str, world: int):
    """One-process runs of each rank's block from the rank's generator."""
    return [run_mcmc_sharded(
        W.build(name), rank_generator(W.gen(W.SEED), r), *W.RUN[:2],
        thinning=W.RUN[2], n_chains=W.N_CHAINS // world,
        extra_fields=("potential_energy",)) for r in range(world)]


def test_initialize_distributed_two_processes_all_reduce(core):
    assert [r["total"] for r in core] == [6.0, 6.0]


def test_chain_mesh_two_in_a_gloo_group(core):
    """chain_mesh() spans the group (its WORLD group), a sub-mesh of one
    leaves rank 1 out, chain_sharding gives rank-major blocks."""
    assert [r["mesh"] for r in core] == [(2, 0, True, True, "cpu"),
                                         (2, 1, True, True, "cpu")]
    assert [r["sub"] for r in core] == [(1, 0, True, None),
                                        (1, 1, False, None)]
    assert [r["sharding"] for r in core] == [slice(0, 4), slice(4, 8)]
    assert [r["replicated"] for r in core] == ["cpu", "cpu"]
    assert all("a mesh of 3 devices in a process group of 2"
               in r["mesh_of_3"] for r in core)


@pytest.mark.parametrize("name", ["arwmh", "asss", "nuts", "sa"])
def test_sharded_draws_equal_the_blocks_one_process_runs(core, name):
    twins = _twins(name, 2)
    want_s = torch.cat([t[0] for t in twins], dim=1)
    want_pe = torch.cat([t[1]["potential_energy"] for t in twins], dim=1)
    for r, res in enumerate(core):
        got = res["runs"][name]
        assert got["samples"].shape == (W.RUN[1] // W.RUN[2], W.N_CHAINS,
                                        10)
        assert torch.equal(got["samples"], want_s)
        assert torch.equal(got["potential_energy"], want_pe)
        assert torch.equal(got["last"], twins[r][2].position)
    # the ranks drew apart
    assert not torch.equal(twins[0][0], twins[1][0])


@pytest.mark.parametrize("name", ["arwmh", "asss"])
def test_one_rank_mesh_equals_the_one_process_driver(one, name):
    (res,) = one
    assert res["mesh"] == (1, True)
    s, extras, last = run_mcmc_sharded(
        W.build(name), W.gen(W.SEED), *W.RUN[:2], thinning=W.RUN[2],
        n_chains=W.N_CHAINS, extra_fields=("potential_energy",))
    got = res["runs"][name]
    assert torch.equal(got["samples"], s)
    assert torch.equal(got["potential_energy"], extras["potential_energy"])
    assert torch.equal(got["last"], last.position)


def test_fan_out_clones_distinct_across_ranks(core):
    fan = core[0]["fan"]
    assert fan.shape == (8, 16, 3) and torch.equal(fan, core[1]["fan"])
    assert len({tuple(row) for row in fan[-1].tolist()}) == 16
    # rank 1's block is its own stream's, not a copy of rank 0's
    assert not torch.equal(fan[:, :8], fan[:, 8:])


@pytest.mark.parametrize("world", [2, 4])
def test_cross_chain_moments_match_jax_mesh(core, scale, world):
    x = W.moments_input()
    jmean, jvar = jpar.cross_chain_moments(jnp.asarray(x), jpar.chain_mesh())
    for res in core if world == 2 else scale:
        got = res["collectives"]
        assert got["mean"].shape == (3,)
        np.testing.assert_allclose(got["mean"].numpy(), np.asarray(jmean),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["var"].numpy(), np.asarray(jvar),
                                   rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gelman_rubin_matches_jax_mesh(core, scale, world):
    want = jpar.sharded_gelman_rubin(jnp.asarray(W.rhat_input()),
                                     jpar.chain_mesh())
    for res in core if world == 2 else scale:
        got = res["collectives"]["rhat"]
        assert got.shape == (3,) and float(got.min()) > 1.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_run_makes_a_fixed_number_of_collectives(core, scale, one, world):
    """An ARWMH run of 12 and of 120 steps makes the same all-reduces:
    one per gathered field (samples, potential energy), none on one rank,
    none inside a step."""
    per_run = 0 if world == 1 else 2
    for res in {1: one, 2: core, 4: scale}[world]:
        counts = res["counts"]
        assert [counts[n] for n in (12, 120)] == [per_run, per_run]
        assert counts["in_step"] == 0


@pytest.mark.parametrize("name", ["asss", "arwmh"])
def test_sample_pnx_mesh_equals_the_ranks_rollouts(core, name):
    """ASSS from seed 11 (rank r from rank_seed(11, r), reseeded per step)
    and ARWMH from a generator (rank r from rank_generator): the grid's 15
    chains padded to 16, 8 a rank, each block rolled in one process as 8
    points of one sample."""
    seeded = name == "asss"
    k = amt.asss(amt.eight_schools_noncentered()) if seeded \
        else amt.arwmh(amt.eight_schools_noncentered())
    x, adapt = W.pnx_input(k, 11 if seeded else 12)
    C = W.PNX_POINTS * W.PNX_SAMPLES
    pos = x.repeat_interleave(W.PNX_SAMPLES, dim=0)
    adapt_grid = map_state(
        lambda t: t.repeat_interleave(W.PNX_SAMPLES, dim=0) if t.dim()
        else t.expand(C), adapt)
    blocks = []
    for r in range(2):
        rows = torch.arange(8 * r, 8 * r + 8).clamp(max=C - 1)
        source = rank_seed(11, r) if seeded \
            else rank_generator(W.gen(12), r)
        blocks.append(sample_pnx(
            k, source, pos[rows], map_state(lambda t: t[rows], adapt_grid),
            n=W.PNX_STEPS, n_samples=1)[:, 0])
        if r == 1 and not seeded:
            # rank 1's caller generator stands where its stream ended
            assert torch.equal(core[1]["pnx_generator_after"],
                               source.get_state())
    want = torch.cat(blocks)[:C].reshape(W.PNX_POINTS, W.PNX_SAMPLES, 10)
    for res in core:
        assert torch.equal(res[f"pnx_{name}"], want)


def test_run_w_eval_two_ranks_writes_once_from_rank_zero(core):
    from adaptive_mcmc_tpu_torch.experiments.runner import (
        TARGETS,
        build_kernel,
    )

    rank0, rank1 = (r["w_eval"] for r in core)
    path = rank0["paths"][0]
    assert rank0["writes"] == [path] and rank1["writes"] == []
    assert rank0["paths"] == rank1["paths"] == [path, path]
    with np.load(path) as z:
        samples, pe = z["samples"], z["potential_energy"]
    assert samples.shape == (5, 10, 10) and pe.shape == (5, 10)
    # 5 seeds padded to 6 chains, 3 a rank, the padded chain dropped
    twins = [run_mcmc_sharded(
        build_kernel("arwmh", TARGETS["eight_schools"](), lr_decay=2 / 3,
                     num_warmup=20),
        rank_generator(torch.Generator().manual_seed(0), r), 20, 40,
        thinning=4, n_chains=3, max_steps_per_call=500_000,
        extra_fields=("potential_energy", "as_change")) for r in range(2)]
    want = torch.cat([t[0] for t in twins], dim=1)[:, :5]
    np.testing.assert_array_equal(samples, want.transpose(0, 1).numpy())


def test_dryrun_multichip_four_processes_on_the_cpu(tmp_path, capsys):
    outs = dryrun_multichip(4, device="cpu",
                            init_method=f"file://{tmp_path}/rendezvous")
    assert len(outs) == 4
    assert ("dryrun_multichip ok on 4 devices (mesh sizes [4, 2], incl. "
            "sharded sample_pnx)") in capsys.readouterr().out
