"""The port's sample-quality metrics against the JAX package's on the same
numpy inputs (CPU): moments, 1-D and sliced Wasserstein (on JAX's own
directions), MMD with the median heuristic, log-domain Sinkhorn (equal
iteration counts), the cost matrix, the exact host solvers (the port's
native Hungarian against SciPy) and the ε-auction (JAX's assignments on the
instances of tests/test_metrics.py; its round kernel's wrapper: the
refusals before the library loads, the plain round on the CPU, the warps
per bidder).  Tolerances: rtol 1e-5 for every
metric, exact for the median, the iteration counts and the assignments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import scipy.spatial

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import adaptive_mcmc_tpu.metrics as jm  # noqa: E402
from adaptive_mcmc_tpu.metrics import assignment as ja  # noqa: E402
from adaptive_mcmc_tpu.metrics import sinkhorn as jsk  # noqa: E402

import adaptive_mcmc_tpu_torch.metrics as tm  # noqa: E402
from adaptive_mcmc_tpu_torch import interop  # noqa: E402
from adaptive_mcmc_tpu_torch.metrics import assignment as ta  # noqa: E402
from adaptive_mcmc_tpu_torch.metrics import mmd as tmmd  # noqa: E402
from adaptive_mcmc_tpu_torch.metrics import sinkhorn as tsk  # noqa: E402
from adaptive_mcmc_tpu_torch.metrics import sliced as tsl  # noqa: E402

RTOL = 1e-5


def _clouds(n=200, d=5, shift=0.5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.standard_normal((n, d)) + shift).astype(np.float32)
    return x, y


def _t(a):
    return torch.tensor(np.asarray(a))


def test_exports_match_the_jax_package():
    names = [n for n in dir(jm) if not n.startswith("_")
             and callable(getattr(jm, n))]
    assert names and all(callable(getattr(tm, n)) for n in names)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_pth_moment_rmse(p):
    x, y = _clouds()
    np.testing.assert_allclose(float(tm.pth_moment_rmse(_t(x), _t(y), p)),
                               float(jm.pth_moment_rmse(x, y, p)), rtol=RTOL)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_wasserstein_1d_batched(p):
    rng = np.random.default_rng(3)
    mu = rng.standard_normal((4, 500)).astype(np.float32)
    nu = (rng.standard_normal((4, 500)) * 1.3 + 0.2).astype(np.float32)
    np.testing.assert_allclose(
        tm.wasserstein_1d(_t(mu), _t(nu), p=p).numpy(),
        np.asarray(jm.wasserstein_1d(mu, nu, p=p)), rtol=RTOL)


def test_sliced_on_jax_directions():
    """The math after the draw, fed the directions of
    jax.random.normal(key, (D, d)), gives JAX's max-sliced and sliced
    values."""
    x, y = _clouds(400, 4, shift=1.0)
    key = jax.random.PRNGKey(0)
    dirs = np.asarray(jax.random.normal(key, (256, 4)))
    per_dir = tsl.sliced_from_directions(_t(x), _t(y), _t(dirs))
    np.testing.assert_allclose(
        float(torch.max(per_dir)),
        float(jm.max_sliced_wasserstein(x, y, key, n_directions=256)),
        rtol=RTOL)
    w2 = tsl.sliced_from_directions(_t(x), _t(y), _t(dirs), p=2.0)
    np.testing.assert_allclose(
        float(torch.mean(w2**2) ** 0.5),
        float(jm.sliced_wasserstein(x, y, key, p=2.0, n_directions=256)),
        rtol=RTOL)


def test_sliced_with_a_generator():
    x, y = _clouds(400, 4, shift=1.0)
    g = torch.Generator().manual_seed(0)
    msw = float(tm.max_sliced_wasserstein(_t(x), _t(y), g, n_directions=256))
    sw = float(tm.sliced_wasserstein(_t(x), _t(y), g, n_directions=256))
    shift = float(np.linalg.norm(y.mean(0) - x.mean(0)))
    assert msw > 0.6 * shift and 0.0 < sw < msw
    assert float(tm.max_sliced_wasserstein(_t(x), _t(x), g, 1.0, 64)) < 1e-6


def test_gaussian_kernel_and_mmd2_unbiased():
    x, y = _clouds(150, 4, shift=1.0)
    np.testing.assert_allclose(
        tm.gaussian_kernel(_t(x), _t(y), 0.5).numpy(),
        np.asarray(jm.gaussian_kernel(x, y, 0.5)), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(float(tm.mmd2_unbiased(_t(x), _t(y), 0.5)),
                               float(jm.mmd2_unbiased(x, y, gamma=0.5)),
                               rtol=RTOL)


def test_median_of_an_even_count_is_the_mean_of_the_middle_pair():
    """jnp.median averages the two middle values of an even count;
    torch.median returns the lower one.  The port takes the mean."""
    v = np.array([[5.0, 1.0], [2.0, 8.0]], np.float32)
    want = float(jnp.median(v))
    assert want == 3.5
    assert float(tmmd.median(_t(v))) == want
    assert float(torch.median(_t(v))) == 2.0
    odd = np.array([4.0, 1.0, 9.0], np.float32)
    assert float(tmmd.median(_t(odd))) == float(jnp.median(odd)) == 4.0


@pytest.mark.parametrize("n", [64, 65])
def test_median_sq_dist(n):
    """n x n pairwise squared distances (even and odd counts) give JAX's
    median exactly."""
    y = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    d = np.asarray(jm.mmd._sq_dists(y, y))
    assert float(tmmd.median(_t(d))) == float(jnp.median(d))
    np.testing.assert_allclose(float(tm.median_sq_dist(_t(y))),
                               float(jm.median_sq_dist(y)), rtol=RTOL)


def test_mmd_heuristic_and_many():
    x, y = _clouds(300, 4, shift=1.0)
    np.testing.assert_allclose(float(tm.mmd_heuristic(_t(x), _t(y))),
                               float(jm.mmd_heuristic(x, y)), rtol=RTOL)
    rng = np.random.default_rng(1)
    ref = rng.standard_normal((200, 5)).astype(np.float32)
    xs = (rng.standard_normal((4, 180, 5)) * 1.3 + 0.2).astype(np.float32)
    got = tm.mmd_heuristic_many(_t(xs), _t(ref)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.mmd_heuristic_many(xs, ref)),
                               rtol=RTOL)
    np.testing.assert_allclose(
        got, [float(tm.mmd_heuristic(_t(x_), _t(ref))) for x_ in xs],
        rtol=1e-6)


def test_sinkhorn_solve_equal_iterations():
    """The solver's value, potentials and marginal error at rtol 1e-5 and
    the same iteration count, loose and tight tolerances."""
    x, y = _clouds(120, 3, shift=1.0)
    cost_j = jsk._euclidean_cost(jnp.asarray(x), jnp.asarray(y))
    cost_t = tsk._euclidean_cost(_t(x), _t(y))
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j),
                               rtol=RTOL, atol=1e-6)
    cost = np.asarray(cost_j)
    eps = float(np.float32(cost.mean() * 0.05))
    for tol, max_iters in ((0.05, 500), (1e-3, 2000)):
        vj, fj, gj, ej, ij = jsk._solve(jnp.asarray(cost), jnp.float32(eps),
                                        tol, max_iters)
        vt, ft, gt, et, it = tsk._solve(_t(cost), torch.tensor(eps), tol,
                                        max_iters)
        assert it == int(ij)
        np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(et, float(ej), rtol=1e-3, atol=1e-6)


def test_wasserstein_sinkhorn_and_unbiased():
    x, y = _clouds(100, 3, shift=1.0)
    np.testing.assert_allclose(tm.wasserstein_sinkhorn(_t(x), _t(y)),
                               jm.wasserstein_sinkhorn(x, y), rtol=RTOL)
    np.testing.assert_allclose(
        tm.wasserstein_sinkhorn_unbiased(_t(x), _t(y)),
        jm.wasserstein_sinkhorn_unbiased(x, y), rtol=RTOL)


@pytest.mark.parametrize("ord_", [1.0, 2.0, 3.0])
def test_minkowski_cost_matrix(ord_):
    x, y = _clouds(50, 4)
    got = tm.minkowski_cost_matrix(_t(x), _t(y), ord=ord_).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.minkowski_cost_matrix(x, y, ord=ord_)),
        rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(
        got, scipy.spatial.distance_matrix(x, y, p=ord_), rtol=1e-4,
        atol=1e-4)


def test_native_assignment_exact_against_scipy():
    """The port's own copy of the Hungarian solver, built with the host
    C++ compiler, gives SciPy's optimal cost on random instances."""
    assert ta.load_native() is not None
    assert ta.lsap_library_path(ta._cxx()).parent == ta.BUILD_DIR
    rng = np.random.default_rng(1)
    for n in [1, 2, 7, 40, 150]:
        cost = rng.random((n, n))
        col = ta.linear_sum_assignment(cost, solver="native")
        r, c = scipy.optimize.linear_sum_assignment(cost)
        assert sorted(col) == list(range(n))
        np.testing.assert_allclose(cost[np.arange(n), col].sum(),
                                   cost[r, c].sum(), rtol=1e-12)
    rect = rng.random((5, 9))
    col = ta.linear_sum_assignment(rect, solver="native")
    r, c = scipy.optimize.linear_sum_assignment(rect)
    np.testing.assert_allclose(rect[np.arange(5), col].sum(),
                               rect[r, c].sum(), rtol=1e-12)
    with pytest.raises(RuntimeError):
        ta.linear_sum_assignment(rng.random((3, 2)), solver="native")
    with pytest.raises(ValueError):
        ta.linear_sum_assignment(rect, solver="hungarian")


@pytest.mark.parametrize("solver", ["scipy", "native", "auto"])
def test_wasserstein_dist11_matches_jax(solver):
    x, y = _clouds(120, 3)
    np.testing.assert_allclose(tm.wasserstein_dist11_p(_t(x), _t(y),
                                                       solver=solver),
                               jm.wasserstein_dist11_p(x, y, solver="scipy"),
                               rtol=RTOL)


def test_block_tier_matches_jax():
    for left in (1, 16, 17, 128, 129, 5000):
        for block, rpc in ((1024, 8192), (64, 512), (8, 10)):
            assert ta._block_tier(left, block, rpc) == \
                ja._block_tier(left, block, rpc)


def test_auction_same_assignment_n64():
    """tests/test_metrics.py's single instance: JAX's assignment and
    prices, within ε_final of the optimum; then a second instance
    warm-started from those prices: JAX's again."""
    n = 64
    rng = np.random.default_rng(2)
    cost = rng.random((n, n)).astype(np.float32)
    cj, pj = ja.auction_assignment(jnp.asarray(cost), return_prices=True)
    ct, pt = ta.auction_assignment(_t(cost), return_prices=True)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    _check_exact_band(cost[None], ct.numpy()[None])
    eps_final = (cost.max() - cost.min()) / (2 * n)
    assert ta.last_levels[-1][0] == pytest.approx(eps_final)
    warm = rng.random((n, n)).astype(np.float32)
    cj = ja.auction_assignment(jnp.asarray(warm), prices_init=pj)
    ct = ta.auction_assignment(_t(warm), prices_init=pt)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert len(ta.last_levels) == 2      # ε_final·10, then ε_final


def test_wasserstein_dist11_auction():
    """The auction path of wasserstein_dist11_p: W within ε_final of the
    exact value, and its prices carried to the next solve."""
    x, y = _clouds(64, 3)
    exact = tm.wasserstein_dist11_p(_t(x), _t(y))
    w, prices = tm.wasserstein_dist11_p(_t(x), _t(y), solver="auction",
                                        return_prices=True)
    cost = tm.minkowski_cost_matrix(_t(x), _t(y))
    bound = float(cost.max() - cost.min()) / 128
    assert prices.shape == (64,) and abs(w - exact) <= bound + 1e-6
    w2 = tm.wasserstein_dist11_p(_t(x), _t(y), solver="auction",
                                 prices_init=prices)
    assert abs(w2 - exact) <= bound + 1e-6


def _batch_costs(seed, B, n, d):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((n, d)).astype(np.float32)
    us = rng.standard_normal((B, n, d)).astype(np.float32)
    return np.stack([np.asarray(jm.minkowski_cost_matrix(u, ref))
                     for u in us])


def _check_exact_band(costs, cols):
    for cost, col in zip(costs.astype(np.float64), cols):
        n = cost.shape[0]
        assert sorted(col.tolist()) == list(range(n))
        r, c = scipy.optimize.linear_sum_assignment(cost)
        bound = (cost.max() - cost.min()) / (2 * n)
        assert cost[np.arange(n), col].mean() - cost[r, c].mean() \
            <= bound + 1e-6


def test_auction_batch_same_assignment():
    """The batch of 3 x 300 of tests/test_metrics.py, block 64 and 512
    rounds per call: JAX's assignments, bit for bit."""
    costs = _batch_costs(3, 3, 300, 4)
    cj = ja.auction_assignment_batch(jnp.asarray(costs), block=64,
                                     rounds_per_call=512)
    ct = ta.auction_assignment_batch(_t(costs), block=64, rounds_per_call=512)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _check_exact_band(costs, ct.numpy())


def test_auction_batch_warm_start_same_assignment():
    """Batches of 3, 3 and 1 instances, each warm-started from the last
    batch's prices (the trailing batch cuts them): JAX's assignments and
    prices, each batch of the port warm-started from JAX's prices carried
    through interop."""
    costs = _batch_costs(11, 7, 250, 4)
    pj = None
    for s0 in range(0, 7, 3):
        batch = costs[s0:s0 + 3]
        carried = None if pj is None else \
            interop.prices_from_numpy(np.asarray(pj))
        cj, pj = ja.auction_assignment_batch(
            jnp.asarray(batch), block=64, rounds_per_call=512,
            prices_init=pj, return_prices=True)
        ct, pt = ta.auction_assignment_batch(
            _t(batch), block=64, rounds_per_call=512, prices_init=carried,
            return_prices=True)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(interop.prices_to_numpy(pt),
                                      np.asarray(pj))
        _check_exact_band(batch, ct.numpy())


def test_auction_batch_tie_dense_same_assignment():
    """tests/test_metrics.py's tie-dense instances (4x duplicated points,
    d = 2): JAX's assignments, so the tie rule is the same (first best
    column, lowest row among equal top bids)."""
    rng = np.random.default_rng(7)
    n, d, B = 400, 2, 3
    x = np.tile(rng.standard_normal((n // 4, d)).astype(np.float32), (4, 1))
    costs = np.stack([
        np.linalg.norm(x[:, None, :] - rng.standard_normal((n, d)).astype(
            np.float32)[None, :, :], axis=-1) for _ in range(B)])
    cj = ja.auction_assignment_batch(jnp.asarray(costs), block=64)
    ct = ta.auction_assignment_batch(_t(costs), block=64)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _check_exact_band(costs, ct.numpy())


def _round_args(B=2, n=5, m=7):
    """Well-formed CPU arguments of one auction round and its scratch."""
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak

    benefit = -torch.rand((B, n, m), generator=torch.Generator()
                          .manual_seed(0))
    return dict(benefit=benefit, prices=torch.zeros((B, m)),
                row_to_col=torch.full((B, n + 1), -1, dtype=torch.int64),
                col_owner=torch.full((B, m), -1, dtype=torch.int64),
                eps=torch.tensor(0.01), live=torch.zeros(B, dtype=torch.int64),
                block=4, scratch=ak.new_scratch(B, n, m, "cpu"))


def _bad_round_args(case):
    args = _round_args()
    if case == "float64":
        args["benefit"] = args["benefit"].double()
    elif case == "non-contiguous":
        args["benefit"] = args["benefit"].transpose(1, 2).contiguous() \
            .transpose(1, 2)
    elif case == "n > m":
        args = _round_args(n=7, m=5)
    elif case == "scratch":
        keys, slots, done = args["scratch"]
        args["scratch"] = (keys, slots[:, :-1], done)
    return args


@pytest.mark.parametrize("case, error, match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("float64", TypeError, "benefit must be torch.float32"),
    ("non-contiguous", ValueError, "benefit must be contiguous"),
    ("n > m", ValueError, "n <= m"),
    ("scratch", TypeError, "slots must be torch.int32"),
])
def test_auction_kernel_wrapper_refuses_before_loading(monkeypatch, case,
                                                        error, match):
    """The kernel's wrapper checks its arguments before it builds or loads
    the library: a CPU tensor, float64, a non-contiguous benefit, n > m and
    scratch of the wrong shape are each refused."""
    from adaptive_mcmc_tpu_torch.ops.cuda import _build
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak

    def no_library(*args, **kwargs):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(_build, "function", no_library)
    before = ak.launches
    with pytest.raises(error, match=match):
        ak.launch_round(**_bad_round_args(case))
    assert ak.launches == before


def test_auction_round_on_the_cpu_runs_the_plain_round():
    """On CPU tensors the dispatch runs the plain round (same buffers as
    auction_round_reference on their twins) and launches nothing; a solve
    counts its rounds in auction.rounds and none in auction.kernel_rounds."""
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak
    from adaptive_mcmc_tpu_torch.utils import profiling

    before = ak.launches
    a, b = _round_args(), _round_args()
    for _ in range(3):
        ak.auction_round(**a)
        ak.auction_round_reference(**{k: v for k, v in b.items()
                                      if k != "scratch"})
    for name in ("row_to_col", "col_owner", "prices", "live"):
        assert torch.equal(a[name], b[name])
    assert int((a["row_to_col"][:, :-1] >= 0).sum()) > 0
    rounds = profiling.totals().get("auction.rounds", 0)
    costs = _batch_costs(5, 2, 40, 3)
    ta.auction_assignment_batch(_t(costs))
    assert profiling.totals()["auction.rounds"] > rounds
    assert profiling.totals().get("auction.kernel_rounds", 0) == 0
    assert ak.launches == before


def test_auction_kernel_rounds_count_the_kernels_launches(monkeypatch):
    """auction.kernel_rounds is read off the kernel's launch count around
    each block, not off the device: a round that counts a launch (here a
    stand-in for the kernel on CPU tensors) is counted, and a solve's
    kernel_rounds then equal its rounds."""
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak
    from adaptive_mcmc_tpu_torch.utils import profiling

    def counted_round(benefit, prices, row_to_col, col_owner, eps, live,
                      block, scratch):
        ak.auction_round_reference(benefit, prices, row_to_col, col_owner,
                                   eps, live, block)
        ak.launches += 1

    monkeypatch.setattr(ak, "auction_round", counted_round)
    before = dict(profiling.totals())
    ta.auction_assignment_batch(_t(_batch_costs(6, 2, 40, 3)), block=8)
    ran = {c: profiling.totals().get(c, 0) - before.get(c, 0)
           for c in ("auction.rounds", "auction.kernel_rounds")}
    assert ran["auction.rounds"] > 0
    assert ran["auction.kernel_rounds"] == ran["auction.rounds"]


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
def test_auction_refuses_non_finite_costs(value):
    """A cost matrix that holds a NaN or an infinity (a draw of a diverged
    chain) is refused on the host before any round, alone or in a batch."""
    costs = _t(_batch_costs(7, 2, 12, 3))
    costs[1, 4, 5] = value
    with pytest.raises(ValueError, match="finite costs"):
        ta.auction_assignment_batch(costs)
    with pytest.raises(ValueError, match="finite costs"):
        ta.auction_assignment(costs[1])


@pytest.mark.parametrize("B, bidders, m, want", [
    (8, 625, 625, 1), (8, 128, 625, 4), (8, 16, 625, 4), (8, 2, 2, 1),
    (8, 1024, 10000, 1), (8, 128, 10000, 4), (8, 16, 10000, 8),
    (1, 1, 512, 4), (1, 1, 1_000_000, 8), (8, 16, 1, 1)])
def test_auction_warps_per_bidder(B, bidders, m, want):
    """Warps per bidding row on 132 SMs: one while the bidders fill half
    the card or the rows are short, up to a block's eight for the endgame's
    few long rows; always a divisor of the block's eight warps."""
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak

    g = ak.warps_per_bidder(B, bidders, m, 132)
    assert g == want and ak.WARPS_PER_BLOCK % g == 0


def test_auction_raises_when_rounds_run_out():
    cost = np.random.default_rng(4).random((40, 40)).astype(np.float32)
    with pytest.raises(RuntimeError, match="max_rounds"):
        ta.auction_assignment(_t(cost), max_rounds=1, rounds_per_call=1)
    with pytest.raises(RuntimeError, match="instances incomplete"):
        ta.auction_assignment_batch(_t(cost[None]), max_rounds=1,
                                    rounds_per_call=1)
    eager = ta.auction_assignment(_t(cost), eager=True)
    assert torch.equal(eager, ta.auction_assignment(_t(cost)))
