"""Port parity for the log-grid collection driver (infer/collect.py): the
grid equals JAX's, the collected states sit on it, and cutting the run into
host-side segments (max_steps_per_call) changes nothing (test_mcmc.py:
94-181).  The port's draws come from a torch.Generator, so runs are
compared with themselves bit for bit and with JAX by the grid and the
shapes only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import adaptive_mcmc_tpu as jamt  # noqa: E402
from adaptive_mcmc_tpu.infer import collect as jcollect  # noqa: E402
import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.infer import collect  # noqa: E402
from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors  # noqa: E402


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("n_pow", [0, 1, 3, 6])
def test_ns_logscale_equals_jax(n_pow):
    got = collect.ns_logscale(n_pow)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcollect.ns_logscale(n_pow)))
    assert int(got[0]) == 1 and int(got[-1]) == 10 ** n_pow


def test_collect_states_logscale_shapes_and_grid():
    t = amt.std_normal(2)
    states, last = collect.collect_states_logscale(
        amt.arwmh(t), _gen(7), n_pow=3, n_chains=2)
    jstates, jlast = jcollect.collect_states_logscale(
        jamt.arwmh(jamt.std_normal(2)), jax.random.PRNGKey(7), n_pow=3,
        n_chains=2)
    n = len(collect.ns_logscale(3))
    for got, want in zip(states, jstates):
        if isinstance(got, tuple):
            for g, w in zip(got, want):
                assert tuple(g.shape) == np.shape(w)
        else:
            assert tuple(got.shape) == np.shape(want)
    assert states.position.shape == (n, 2, 2)
    assert states.as_change.shape == (n, 2)
    np.testing.assert_array_equal(states.i.numpy(), np.asarray(jstates.i))
    assert int(last.i) == int(jlast.i) == 1000
    # each collected state is its own copy: frames differ
    assert bool((states.position[1:] != states.position[:-1]).any())
    torch.testing.assert_close(states.position[-1], last.position,
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["arwmh", "sa"])
def test_chunked_collection_equals_unchunked(name):
    """max_steps_per_call segments the same grid on the same draws."""
    t = amt.std_normal(2)
    k = amt.arwmh(t) if name == "arwmh" else \
        amt.sa(t, amt.SAConfig(adapt_state_size=8))
    n_pow = 3 if name == "arwmh" else 2
    a, last_a = collect.collect_states_logscale(k, _gen(3), n_pow=n_pow,
                                                n_chains=4)
    b, last_b = collect.collect_states_logscale(k, _gen(3), n_pow=n_pow,
                                                n_chains=4,
                                                max_steps_per_call=7)
    for x, y in zip(state_tensors(a) + state_tensors(last_a),
                    state_tensors(b) + state_tensors(last_b)):
        assert torch.equal(x, y)


def test_concat_trees_leafwise():
    k = amt.arwmh(amt.std_normal(2))
    s = k.init(_gen(0), n_chains=3)
    stacked = collect.concat_trees([
        amt.ARWMHState(*[x[None] if isinstance(x, torch.Tensor) else
                         type(x)(*[y[None] for y in x]) for x in s])
        for _ in range(2)])
    assert stacked.position.shape == (2, 3, 2)
    assert stacked.adapt_state.scale.shape == (2, 3, 2, 2)
    assert stacked.i.shape == (2,)
