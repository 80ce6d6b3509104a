"""The ASSS machine in blocks of iterations (ops/cuda/asss_fused.Machine):
the pipelined step_n's machine (its rank-1 update through K1's chains-last
entry, whose plain version runs on the CPU) against the JAX fused kernel
in interpret mode on injected draws, at test_torch_asss_fused.py's
normwise tolerance; the block length changes nothing on injected draws;
the adaptation clock is a tensor, so two calls equal one call of their
sum; ``eager=True`` gives the same result on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from adaptive_mcmc_tpu.kernels.asss import ASSSConfig as JConfig  # noqa: E402
from adaptive_mcmc_tpu.ops.pallas.asss_fused import (  # noqa: E402
    build_fused_asss as jbuild_fused,
)
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cholesky import (  # noqa: E402
    adaptive_scale_update_cl,
)
from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3  # noqa: E402
from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402
from test_torch_asss_fused import (  # noqa: E402
    NAMES,
    _inputs,
    _jax_state,
    _torch_state,
    assert_close_normwise,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _fields(s):
    a = s.adapt_state
    return {"i": s.i, "position": s.position, "pe": s.potential_energy,
            "loc": a.loc, "scale": a.scale, "as_change": s.as_change}


@pytest.mark.parametrize("block", [3, 16])
def test_pipelined_machine_matches_jax_machine_injected(monkeypatch, block):
    """25 steps with 4 frames at thinning 6 (one chunk): state and frames
    of the machine with K1's update against the JAX kernel, for a block
    length that divides nothing and for the default."""
    monkeypatch.setattr(k3, "GRAPH_ITERS", block)
    jt, state, unif3, n01 = _inputs(seed=5)
    F, thin = 4, 6
    want_state, want = jbuild_fused(jt, JConfig(num_warmup=10))(
        _jax_state(state), F * thin, n_frames=F, thinning=thin,
        unif3=jnp.asarray(unif3), n01=jnp.asarray(n01), interpret=True)
    machine = k3.Machine(amt.eight_schools_noncentered(),
                         amt.ASSSConfig(num_warmup=10),
                         adaptive_scale_update_cl)
    before = profiling.totals().get("asss.machine_iters", 0)
    got_state, got, iters = machine.run(
        _torch_state(state), F * thin, F, thin,
        unif3=torch.from_numpy(unif3), n01=torch.from_numpy(n01))
    ran = profiling.totals()["asss.machine_iters"] - before
    assert ran % block == 0 and ran >= int(iters.max()) - 1
    for g, w, name in zip(got_state, want_state, NAMES):
        assert_close_normwise(g.numpy(), w, name)
    for k in ("position", "potential_energy", "as_change"):
        assert_close_normwise(got[k].numpy(), want[k], k)


def test_block_length_changes_nothing_on_injected_draws(monkeypatch):
    jt, state, unif3, n01 = _inputs(seed=7)
    runs = []
    for block in (1, 5, 16):
        monkeypatch.setattr(k3, "GRAPH_ITERS", block)
        runs.append(k3.Machine(
            amt.eight_schools_noncentered(), amt.ASSSConfig(num_warmup=4))
            .run(_torch_state(state), 12, 3, 4, unif3=torch.from_numpy(unif3),
                 n01=torch.from_numpy(n01)))
    for st, frames, iters in runs[1:]:
        for a, b in zip(st, runs[0][0]):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        for k in frames:
            assert torch.equal(frames[k], runs[0][1][k])
        assert torch.equal(iters, runs[0][2])


@pytest.mark.parametrize("split", [(3, 4), (5, 2), (1, 9)])
def test_two_step_n_calls_equal_one_call_of_their_sum(split):
    """With max_shrinkage_iters=0 every transition lands in one iteration
    and stays put, so the draws change nothing and the adaptation depends
    on the clock alone (across the warmup boundary at 5): two calls,
    the second starting at i = a, equal one call of a + b steps."""
    a, b = split
    k = amt.asss(amt.eight_schools_noncentered(),
                 amt.ASSSConfig(num_warmup=5, max_shrinkage_iters=0))
    s0 = k.init(_gen(1), n_chains=6)
    one = k.step_n(s0, a + b, _gen(2))
    two = k.step_n(k.step_n(s0, a, _gen(3)), b, _gen(4))
    assert int(one.i) == int(two.i) == a + b
    for name, w in _fields(one).items():
        np.testing.assert_array_equal(_fields(two)[name].numpy(), w.numpy(),
                                      err_msg=name)
    assert not torch.equal(one.adapt_state.scale, s0.adapt_state.scale)
    assert torch.equal(one.position, s0.position)


def test_the_clock_starts_at_the_states_i():
    """A state whose i is 7 adapts as the machine at i0 = 7: equal to a
    call given the same state with i as a plain int."""
    t = amt.eight_schools_noncentered()
    cfg = amt.ASSSConfig(num_warmup=10)
    jt, state, unif3, n01 = _inputs(seed=2)
    st = list(_torch_state(state))
    u, n = torch.from_numpy(unif3), torch.from_numpy(n01)
    machine = k3.Machine(t, cfg)
    st[4] = 7
    want = machine.run(tuple(st), 9, unif3=u, n01=n)
    st[4] = torch.tensor(7, dtype=torch.int32)
    got = machine.run(tuple(st), 9, unif3=u, n01=n)
    assert int(got[0][4]) == int(want[0][4]) == 16
    for a, b in zip(got[0], want[0]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    st[4] = 0
    other = machine.run(tuple(st), 9, unif3=u, n01=n)
    assert not torch.equal(other[0][3], want[0][3])


def test_eager_is_accepted_and_changes_nothing_on_the_cpu():
    k = amt.asss(amt.eight_schools_noncentered(),
                 amt.ASSSConfig(num_warmup=10))
    s0 = k.init(_gen(5), n_chains=8)
    a = k.step_n(s0, 12, _gen(6))
    b = k.step_n(s0, 12, _gen(6), eager=True)
    for name, w in _fields(a).items():
        np.testing.assert_array_equal(_fields(b)[name].numpy(), w.numpy(),
                                      err_msg=name)
    sa, fa = k.collect_n(a, 3, 2, _gen(7))
    sb, fb = k.collect_n(a, 3, 2, _gen(7), eager=True)
    assert torch.equal(sa.position, sb.position)
    for f in fa:
        assert torch.equal(fa[f], fb[f])


def test_fused_none_resolves_to_the_machine_without_a_card(monkeypatch):
    """fused=None is K3 only where a CUDA device is present and
    AMT_ASSS_FUSED=1 (ARWMH: AMT_ARWMH_FUSED=1, adapting, d <= 16)."""
    import importlib

    kasss = importlib.import_module("adaptive_mcmc_tpu_torch.kernels.asss")
    built = []
    monkeypatch.setattr(kasss, "build_fused_asss",
                        lambda t, c: built.append(t.name))
    monkeypatch.setenv("AMT_ASSS_FUSED", "1")
    monkeypatch.setenv("AMT_ARWMH_FUSED", "1")
    t = amt.eight_schools_noncentered()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert amt.arwmh(t).step_n is None
    amt.asss(t)
    assert built == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert amt.arwmh(t).step_n is not None
    assert amt.arwmh(amt.diamonds()).step_n is None
    assert amt.arwmh(t, amt.ARWMHConfig(adapt=False)).step_n is None
    amt.asss(t)
    assert built == [t.name]
    amt.asss(t, amt.ASSSConfig(fused=False))
    monkeypatch.delenv("AMT_ASSS_FUSED")
    monkeypatch.delenv("AMT_ARWMH_FUSED")
    amt.asss(t)
    assert built == [t.name]
    assert amt.arwmh(t).step_n is None
