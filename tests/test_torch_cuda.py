"""CUDA kernels of adaptive_mcmc_tpu_torch against their plain PyTorch
versions on the card, the main path through them, and the CUDA graphs of
the drivers (NUTS's machine against its eager blocks included).  Marked
``cuda``: each test needs a CUDA device and nvcc, and skips where
torch.cuda.is_available() is false.  Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q -n 0``."""

import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu_torch.infer.mcmc import state_tensors  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import _build  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused as k2  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as k3  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import chol_update as k1  # noqa: E402
from adaptive_mcmc_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chol_inputs(C, d, device, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(C, d, d)) * 0.4
    L = np.linalg.cholesky(np.einsum("cij,ckj->cik", a, a) + np.eye(d))
    Lt = torch.tensor(L.transpose(1, 2, 0), dtype=torch.float32,
                      device=device).contiguous()
    vt = torch.tensor(rng.normal(size=(d, C)), dtype=torch.float32,
                      device=device)
    coef = torch.linspace(0.01, 0.9, C, device=device)
    return Lt, vt, coef


def _first(Lt, vt):
    """The chains-first copies of chains-last inputs."""
    return Lt.permute(2, 0, 1).contiguous(), vt.t().contiguous()


def _check_k1_both_layouts(Lt, vt, coef):
    """Both entries against the plain version within 1e-5, and the
    chains-first kernel against the chains-last kernel bit for bit."""
    L, v = _first(Lt, vt)
    before = k1.launches
    last = k1.chol_update_cl(Lt, vt, coef)
    first = k1.chol_update(L, v, coef)
    assert k1.launches == before + 2
    want = k1.chol_update_cl_reference(Lt, vt, coef)
    torch.cuda.synchronize()
    assert first.is_contiguous() and first.shape == L.shape
    torch.testing.assert_close(last, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(first, k1.chol_update_reference(L, v, coef),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(first, last.permute(2, 0, 1))
    assert torch.equal(first, torch.tril(first))
    assert bool((torch.diagonal(first, 0, 1, 2) > 0).all())


@pytest.mark.parametrize("d", list(range(1, 33)))
def test_k1_matches_plain_version_for_every_d(cuda, d):
    _check_k1_both_layouts(*_chol_inputs(37, d, cuda, seed=d))


@pytest.mark.parametrize("d", [10, 26])
@pytest.mark.parametrize("C", [1, 31, 33, 4097])
def test_k1_ragged_chain_counts(cuda, C, d):
    """Chain counts that fill no whole block, in both layouts; the floats
    around the output stay untouched."""
    Lt, vt, coef = _chol_inputs(C, d, cuda, seed=C)
    _check_k1_both_layouts(Lt, vt, coef)
    L, v = _first(Lt, vt)
    # a view into the middle of a larger buffer: the kernel writes its own
    # C chains only
    pad = torch.full((C + 2, d, d), 7.0, device=cuda)
    pad[1:-1] = L
    got = k1.chol_update(pad[1:-1], v, coef)
    assert torch.equal(got, k1.chol_update(L, v, coef))
    assert bool((pad[0] == 7.0).all()) and bool((pad[-1] == 7.0).all())


def test_k1_downdate_gives_nan(cuda):
    d, C = 4, 128
    Lt = torch.eye(d, device=cuda)[:, :, None].expand(d, d, C).contiguous()
    vt = torch.zeros((d, C), device=cuda)
    vt[0] = 10.0
    coef = torch.full((C,), -1.0, device=cuda)
    got = k1.chol_update_cl(Lt, vt, coef)
    want = k1.chol_update_cl_reference(Lt, vt, coef)
    assert bool(torch.isnan(got).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    first = k1.chol_update(*_first(Lt, vt), coef).permute(1, 2, 0)
    assert torch.equal(torch.isnan(first), torch.isnan(got))
    assert torch.equal(torch.nan_to_num(first), torch.nan_to_num(got))


def test_k1_takes_strided_views(cuda):
    """Non-contiguous L and v (the other layout's views) give the bits of
    the contiguous call."""
    Lt, vt, coef = _chol_inputs(130, 10, cuda, seed=3)
    L, v = _first(Lt, vt)
    assert torch.equal(k1.chol_update(Lt.permute(2, 0, 1), vt.t(), coef),
                       k1.chol_update(L, v, coef))
    assert torch.equal(k1.chol_update_cl(L.permute(1, 2, 0), v.t(), coef),
                       k1.chol_update_cl(Lt, vt, coef))


@pytest.mark.parametrize("thinning", [1, 5])
@pytest.mark.parametrize("name", ["arwmh", "rwm"])
def test_graph_run_equals_eager_run(cuda, name, thinning):
    """run_mcmc from the CUDA graph gives the eager loop's draws, extras and
    last state bit for bit from the same seed (warmup 13: whole blocks and
    single steps), leaves the caller's init_state as it was, counts K1 once
    per step, and moves the generator on as the eager loop does."""
    t = amt.eight_schools_noncentered()
    k = amt.arwmh(t, amt.ARWMHConfig(num_warmup=13)) if name == "arwmh" \
        else amt.rwm(t, step_size=0.3)
    C, W, N = 256, 13, 40
    fields = ("potential_energy", "as_change")
    init = k.init(torch.Generator(cuda).manual_seed(5), n_chains=C)
    kept = [x.clone() for x in state_tensors(init)]
    out, gens, counts = [], [], []
    for eager in (True, False):
        g = torch.Generator(cuda).manual_seed(6)
        k1.launches = 0
        out.append(amt.run_mcmc(k, g, W, N, thinning=thinning, n_chains=C,
                                init_state=init, extra_fields=fields,
                                eager=eager))
        torch.cuda.synchronize()
        counts.append(k1.launches)
        gens.append(torch.rand(4, generator=g, device=cuda))
    (want, want_x, want_last), (got, got_x, got_last) = out
    assert torch.equal(got, want)
    for f in fields:
        assert torch.equal(got_x[f], want_x[f])
    for a, b in zip(state_tensors(got_last), state_tensors(want_last)):
        assert torch.equal(a, b)
    for a, b in zip(state_tensors(init), kept):
        assert torch.equal(a, b)
    assert counts[0] == counts[1] == (W + N if name == "arwmh" else 0)
    assert torch.equal(gens[0], gens[1])
    # successive replays propose anew: frames differ from one another
    assert not torch.equal(got[0], got[1]) and not torch.equal(got[1], got[2])
    assert int(got_last.i) == W + N


def test_graph_refuses_a_potential_that_reads_the_host(cuda):
    import dataclasses as dc
    base = amt.eight_schools_noncentered()

    def potential(x):
        pe = base.potential_fn(x)
        return pe + 0.0 * pe.max().item()

    k = amt.arwmh(dc.replace(base, potential_fn=potential,
                             device_potential=None))
    with pytest.raises(RuntimeError, match=r"arwmh\.step.*eager=True"):
        amt.run_mcmc(k, torch.Generator(cuda).manual_seed(0), 4, 8,
                     n_chains=8)
    samples, _, _ = amt.run_mcmc(k, torch.Generator(cuda).manual_seed(0), 4,
                                 8, n_chains=8, eager=True)
    assert samples.is_cuda and bool(torch.isfinite(samples).all())


def test_k2_matches_plain_version_injected(cuda):
    t = amt.eight_schools_noncentered()
    cfg = amt.ARWMHConfig(num_warmup=4)
    C, S, d = 256, 16, t.dim
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.rand((C, d), generator=g, device=cuda) * 4 - 2
    state = (x, t.potential_fn(x), torch.zeros(C, device=cuda), x.clone(),
             torch.eye(d, device=cuda).expand(C, d, d).contiguous(),
             torch.zeros(C, device=cuda),
             torch.zeros((), dtype=torch.int32, device=cuda))
    noise = torch.randn((S, C, d), generator=g, device=cuda)
    unif = torch.rand((S, C), generator=g, device=cuda)
    before = k2.launches
    got, gf = k2.build_fused_arwmh(t, cfg)(state, S, 4, 4, noise=noise,
                                           unif=unif)
    assert k2.launches == before + 1
    want, wf = k2.fused_arwmh_reference(t, cfg, state, S, 4, 4, noise=noise,
                                        unif=unif)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)
    for k in wf:
        torch.testing.assert_close(gf[k], wf[k], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_main_path_goes_through_the_kernels(cuda, fused):
    t = amt.eight_schools_noncentered()
    k1.launches = k2.launches = 0
    mcmc = amt.MCMC(amt.arwmh(t, amt.ARWMHConfig(fused=fused)),
                    num_warmup=200, num_samples=400, thinning=4,
                    n_chains=256)
    mcmc.run(torch.Generator(cuda).manual_seed(1))
    samples = mcmc.get_samples(flat_unconstrained=True)
    assert samples.is_cuda and samples.shape == (100 * 256, t.dim)
    assert bool(torch.isfinite(samples).all())
    assert (k2.launches if fused else k1.launches) > 0


def _asss_state(t, C, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.rand((C, t.dim), generator=g, device=device) * 4 - 2
    return g, (x, t.potential_fn(x), x.clone(),
               torch.eye(t.dim, device=device).expand(C, t.dim, t.dim)
               .contiguous(), 0, torch.zeros(C, device=device))


def test_k3_matches_plain_version_injected(cuda):
    t = amt.eight_schools_noncentered()
    cfg = amt.ASSSConfig(num_warmup=8)
    C, d, rows = 256, t.dim, 512
    g, state = _asss_state(t, C, cuda, 0)
    unif3 = torch.rand((rows, 3, C), generator=g, device=cuda) \
        .clamp_(1e-6, 1 - 1e-6)
    n01 = torch.randn((rows, d + 1, C), generator=g, device=cuda)
    before = k3.launches
    got, gf, gi = k3.build_fused_asss(t, cfg)(
        state, 16, 4, 4, unif3=unif3, n01=n01, return_iters=True)
    assert k3.launches == before + 1
    want, wf, wi = k3.fused_asss_reference(
        t, cfg, state, 16, 4, 4, unif3=unif3, n01=n01, return_iters=True)
    assert int(gi.max()) <= rows
    assert torch.equal(gi, wi)
    for k in (0, 1, 2, 3, 5):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-6)
    for k in wf:
        torch.testing.assert_close(gf[k], wf[k], rtol=2e-5, atol=2e-6)


def test_k3_bailout_stays_put(cuda):
    t = amt.eight_schools_noncentered()
    g, state = _asss_state(t, 128, cuda, 1)
    out, _, iters = k3.build_fused_asss(
        t, amt.ASSSConfig(max_shrinkage_iters=0))(
            state, 5, generator=g, return_iters=True)
    assert torch.equal(out[0], state[0]) and int(out[4]) == 5
    assert bool((iters == 6).all())


def test_asss_main_path_goes_through_k3(cuda):
    t = amt.eight_schools_noncentered()
    k3.launches = 0
    mcmc = amt.MCMC(amt.asss(t, amt.ASSSConfig(fused=True)),
                    num_warmup=200, num_samples=400, thinning=4,
                    n_chains=256)
    mcmc.run(torch.Generator(cuda).manual_seed(1))
    samples = mcmc.get_samples(flat_unconstrained=True)
    assert samples.is_cuda and samples.shape == (100 * 256, t.dim)
    assert bool(torch.isfinite(samples).all())
    assert k3.launches > 0


@pytest.mark.parametrize("lockstep", [False, True])
def test_asss_drivers_go_through_k1(cuda, lockstep):
    kernel = amt.asss(amt.eight_schools_noncentered(),
                      amt.ASSSConfig(num_warmup=20))
    if lockstep:
        kernel = dataclasses.replace(kernel, step_n=None, collect_n=None)
    k1.launches = 0
    samples, _, last = amt.run_mcmc(kernel, torch.Generator(cuda)
                                    .manual_seed(2), 20, 40, thinning=2,
                                    n_chains=64)
    assert samples.is_cuda and bool(torch.isfinite(samples).all())
    assert int(last.i) == 60 and k1.launches > 0


# the instantiations of K2 and K3 by target builder
K2_TARGETS = ("eight_schools_noncentered", "eight_schools_centered", "kidiq",
              "diamonds")
K3_TARGETS = K2_TARGETS


def _start(t, C, device, seed):
    """Positions near the posterior's mass for kidiq and diamonds (the
    gold draws' mean and covariance, or a rough fit), uniform (-2, 2)
    otherwise; loc there too and the identity or the covariance's factor."""
    g = torch.Generator(device).manual_seed(seed)
    d = t.dim
    if t.name == "diamonds":
        gold = np.load(amt.models.data.DATA_DIR
                       / "diamonds.npy").astype(np.float64)
        mean, S = gold.mean(0), np.linalg.cholesky(np.cov(gold.T))
        sd = gold.std(0)
    elif t.name == "kidiq":
        mean = np.array([26.0, 6.0, 0.6, np.log(17.5)])
        sd = np.array([9.0, 2.3, 0.06, 0.035])
        S = np.diag(sd)
    else:
        x = torch.rand((C, d), generator=g, device=device) * 4 - 2
        return g, x, x.clone(), torch.eye(d, device=device).expand(C, d, d)
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.tensor(mean, **f32) + torch.randn(
        (C, d), generator=g, device=device) * torch.tensor(sd, **f32)
    return (g, x, torch.tensor(mean, **f32).expand(C, d).clone(),
            torch.tensor(S, **f32).expand(C, d, d))


@pytest.mark.parametrize("name", K3_TARGETS)
def test_device_potential_matches_potential_fn(cuda, name):
    """The __device__ twin in the operation order of potential_fn: equal
    up to the float32 rounding the card gives both alike."""
    t = getattr(amt, name)()
    _, x, _, _ = _start(t, 512, cuda, 3)
    x = torch.cat([x, torch.rand_like(x) * 4 - 2])
    got, want = k3.device_potential(t, x), t.potential_fn(x)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("name", K3_TARGETS)
def test_k3_instantiation_matches_plain_version(cuda, name):
    t = getattr(amt, name)()
    cfg = amt.ASSSConfig(num_warmup=8)
    C, d, rows = 256, t.dim, 512
    g, x, loc, S = _start(t, C, cuda, 4)
    state = (x, t.potential_fn(x), loc, S.contiguous(), 0,
             torch.zeros(C, device=cuda))
    unif3 = torch.rand((rows, 3, C), generator=g, device=cuda) \
        .clamp_(1e-6, 1 - 1e-6)
    n01 = torch.randn((rows, d + 1, C), generator=g, device=cuda)
    before = k3.launches
    got, gf, gi = k3.build_fused_asss(t, cfg)(
        state, 16, 4, 4, unif3=unif3, n01=n01, return_iters=True)
    assert k3.launches == before + 1
    want, wf, wi = k3.fused_asss_reference(
        t, cfg, state, 16, 4, 4, unif3=unif3, n01=n01, return_iters=True)
    assert int(gi.max()) <= rows
    assert torch.equal(gi, wi)
    for k in (0, 1, 2, 3, 5):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-6)
    for k in wf:
        torch.testing.assert_close(gf[k], wf[k], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", K2_TARGETS)
def test_k2_instantiation_matches_plain_version(cuda, name):
    t = getattr(amt, name)()
    cfg = amt.ARWMHConfig(num_warmup=4)
    C, S, d = 256, 16, t.dim
    g, x, loc, L = _start(t, C, cuda, 5)
    state = (x, t.potential_fn(x), torch.zeros(C, device=cuda), loc,
             L.contiguous(), torch.zeros(C, device=cuda),
             torch.zeros((), dtype=torch.int32, device=cuda))
    noise = torch.randn((S, C, d), generator=g, device=cuda)
    unif = torch.rand((S, C), generator=g, device=cuda)
    got, gf = k2.build_fused_arwmh(t, cfg)(state, S, 4, 4, noise=noise,
                                           unif=unif)
    want, wf = k2.fused_arwmh_reference(t, cfg, state, S, 4, 4, noise=noise,
                                        unif=unif)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)
    for k in wf:
        torch.testing.assert_close(gf[k], wf[k], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("lib,name", [("asss_fused", n) for n in K3_TARGETS]
                         + [("arwmh_fused", n) for n in K2_TARGETS])
def test_instantiation_refuses_a_wrong_d(cuda, lib, name):
    """Each entry point checks D against its potential's and returns
    cudaErrorInvalidValue (1) before any launch."""
    t = getattr(amt, name)()
    tag, C, d = t.device_potential, 64, t.dim + 1
    data = t.data.on(cuda)["kernel_data"]
    x = torch.zeros((C, d), device=cuda)
    out = torch.empty(C, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    if lib == "asss_fused":
        fn = _build.function(lib, f"asss_fused_potential_{tag}",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
        assert fn(x.data_ptr(), out.data_ptr(), data.data_ptr(),
                  data.numel(), C, d, stream) == 1
        st = k3._prepare((x, out, x, torch.zeros((C, d, d), device=cuda), 0,
                          out), 1, 0, 1, torch.Generator(cuda), None,
                         None)[0]
        args = k3.kernel_args(amt.ASSSConfig(), st, torch.zeros(
            C, dtype=torch.int32, device=cuda), data, None, None, {}, 1, 0,
            1, 0, 1)
        fn = _build.function(lib, f"asss_fused_{tag}", k3._ARGTYPES)
    else:
        st = {k: torch.zeros(s, device=cuda) for k, s in (
            ("x", (d, C)), ("pe", C), ("map", C), ("loc", (d, C)),
            ("L", (d, d, C)), ("lam", C), ("as", C))}
        args = k2.kernel_args(amt.ARWMHConfig(), st, data, 0, 1, 0, 1,
                              None, None, {}, 1)
        fn = _build.function(lib, f"arwmh_fused_{tag}", k2._ARGTYPES)
    assert fn(*args, stream) == 1
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        _build.check(1, f"{lib}_{tag}")


@pytest.mark.parametrize("name", K3_TARGETS)
def test_asss_main_path_goes_through_k3_per_target(cuda, name):
    t = getattr(amt, name)()
    k3.launches = 0
    mcmc = amt.MCMC(amt.asss(t, amt.ASSSConfig(fused=True)),
                    num_warmup=200, num_samples=400, thinning=4,
                    n_chains=128)
    mcmc.run(torch.Generator(cuda).manual_seed(1))
    samples = mcmc.get_samples(flat_unconstrained=True)
    assert samples.is_cuda and samples.shape == (100 * 128, t.dim)
    assert bool(torch.isfinite(samples).all())
    assert k3.launches > 0


@pytest.mark.parametrize("name", K2_TARGETS)
def test_arwmh_main_path_goes_through_k2_per_target(cuda, name):
    t = getattr(amt, name)()
    k2.launches = 0
    mcmc = amt.MCMC(amt.arwmh(t, amt.ARWMHConfig(fused=True)),
                    num_warmup=200, num_samples=400, thinning=4,
                    n_chains=128)
    mcmc.run(torch.Generator(cuda).manual_seed(1))
    samples = mcmc.get_samples(flat_unconstrained=True)
    assert samples.is_cuda and samples.shape == (100 * 128, t.dim)
    assert bool(torch.isfinite(samples).all())
    assert k2.launches > 0


@pytest.mark.parametrize("lib", ["arwmh_fused", "asss_fused"])
@pytest.mark.parametrize("name", K2_TARGETS)
def test_cooperative_nan_guard_keeps_the_factor(cuda, lib, name):
    """Chain 0's factor has a zero last diagonal entry, so every rank-1
    update of it divides by zero in the last column, on one lane of its
    group only: the group's vote keeps the old factor bit for bit, and the
    other chains match the plain version."""
    t = getattr(amt, name)()
    C, d, n = 64, t.dim, 16
    g, x, loc, L = _start(t, C, cuda, 6)
    L = L.contiguous().clone()
    L[0, d - 1, d - 1] = 0.0
    if lib == "arwmh_fused":
        cfg = amt.ARWMHConfig(num_warmup=4)
        state = (x, t.potential_fn(x), torch.zeros(C, device=cuda), loc, L,
                 torch.zeros(C, device=cuda),
                 torch.zeros((), dtype=torch.int32, device=cuda))
        draws = dict(noise=torch.randn((n, C, d), generator=g, device=cuda),
                     unif=torch.rand((n, C), generator=g, device=cuda))
        got, _ = k2.build_fused_arwmh(t, cfg)(state, n, **draws)
        want, _ = k2.fused_arwmh_reference(t, cfg, state, n, **draws)
        fields, factor = (0, 1, 2, 3, 4, 5, 7), 4
    else:
        cfg = amt.ASSSConfig(num_warmup=8)
        state = (x, t.potential_fn(x), loc, L, 0, torch.zeros(C, device=cuda))
        draws = dict(
            unif3=torch.rand((512, 3, C), generator=g, device=cuda)
            .clamp_(1e-6, 1 - 1e-6),
            n01=torch.randn((512, d + 1, C), generator=g, device=cuda))
        got, _ = k3.build_fused_asss(t, cfg)(state, n, **draws)
        want, _ = k3.fused_asss_reference(t, cfg, state, n, **draws)
        fields, factor = (0, 1, 2, 3, 5), 3
    assert torch.equal(got[factor][0], L[0])
    assert not torch.equal(got[factor][1:], L[1:])
    for k in fields:
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-6)


EIGHT_SCHOOLS = ("eight_schools_noncentered", "eight_schools_centered")


@pytest.mark.parametrize("lib", ["arwmh_fused", "asss_fused"])
@pytest.mark.parametrize("name", EIGHT_SCHOOLS)
def test_eight_schools_main_path_fits_the_card_in_one_wave(cuda, lib, name):
    """The 4096 chains of the main path are resident at once on the card's
    SMs, whatever lanes per chain the policy takes."""
    t = getattr(amt, name)()
    lanes, threads, per_sm = _build.layout(lib, t.device_potential)
    blocks = -(-4096 * lanes // threads)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks <= per_sm * sms


def test_k1_layout_at_every_d(cuda):
    """K1 reports the layout of both kernels at every d it takes, for a
    few thousand chains and for hundreds of thousands: a group of lanes
    that divides a warp per chain, blocks of whole warps, room for at least
    one block per SM; the main path's 4096 chains at d = 10 put a block of
    the chains-first kernel on at least 128 SMs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for d in range(1, 33):
        for tag in (f"d{d}", f"cl_d{d}"):
            for C in (4096, 417792):
                lanes, threads, per_sm = _build.layout("chol_update", tag, C)
                assert 32 % lanes == 0 and threads % 32 == 0 and per_sm > 0
    lanes, threads, _ = _build.layout("chol_update", "d10", 4096)
    assert min(sms, -(-4096 * lanes // threads)) >= 128
    # one thread per chain once the chains alone fill the card
    assert _build.layout("chol_update", "d10", 417792)[0] == 1


@pytest.mark.parametrize("name", EIGHT_SCHOOLS)
def test_k3_chains_of_one_warp_land_on_different_iterations(cuda, name):
    """Two chains in one warp, one group of lanes each: chain 0's slice
    levels lie 13.8 nats above its potential and chain 1's at it, so they
    shrink different numbers of times and the warp's two groups part ways.
    Each chain's state, frames and iteration count match the plain
    version's."""
    t = getattr(amt, name)()
    lanes, _, _ = _build.layout("asss_fused", t.device_potential)
    assert lanes < 32
    cfg = amt.ASSSConfig(num_warmup=8)
    C, d, rows, n = 2, t.dim, 256, 16
    rng = np.random.default_rng(13)
    f32 = dict(dtype=torch.float32, device=cuda)
    x = torch.tensor(rng.uniform(-2, 2, (C, d)), **f32)
    unif3 = rng.uniform(1e-6, 1 - 1e-6, (rows, 3, C))
    unif3[:, 1, 0] = 1e-6
    unif3[:, 1, 1] = 1.0
    unif3 = torch.tensor(unif3, **f32)
    n01 = torch.tensor(rng.normal(size=(rows, d + 1, C)), **f32)
    state = (x, t.potential_fn(x), x.clone(),
             torch.eye(d, **f32).expand(C, d, d).contiguous(), 0,
             torch.zeros(C, **f32))
    got, gf, gi = k3.build_fused_asss(t, cfg)(
        state, n, 2, 4, unif3=unif3, n01=n01, return_iters=True)
    want, wf, wi = k3.fused_asss_reference(
        t, cfg, state, n, 2, 4, unif3=unif3, n01=n01, return_iters=True)
    assert torch.equal(gi, wi)
    assert int(gi[0]) != int(gi[1]) and int(gi.max()) <= rows
    for k in (0, 1, 2, 3, 5):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-6)
    for k in wf:
        torch.testing.assert_close(gf[k], wf[k], rtol=2e-5, atol=2e-6)


def test_sa_step_on_the_card_matches_the_cpu(cuda):
    """One SA step on the card (three K1 launches) against the same step on
    the CPU (K1's plain version) from the same state and draws."""
    t = amt.eight_schools_noncentered()
    k = amt.sa(t)
    g = torch.Generator().manual_seed(8)
    st = k.init(g, n_chains=64)
    N = st.adapt_state.zs.shape[1]
    draws = amt.SADraws(torch.randn((64, t.dim), generator=g),
                        torch.rand((64, N + 1), generator=g),
                        torch.randint(0, N, (64,), generator=g))
    want = k.step(st, None, draws)
    before = k1.launches
    got = k.step(amt.SAState(*[
        x.to(cuda) if isinstance(x, torch.Tensor) else
        type(x)(*[y.to(cuda) for y in x]) for x in st]), None,
        amt.SADraws(*[x.to(cuda) for x in draws]))
    torch.cuda.synchronize()
    assert k1.launches == before + 3
    for a, b in zip(state_tensors(got), state_tensors(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5,
                                   equal_nan=True)


def test_sa_graph_run_equals_eager_run(cuda):
    k = amt.sa(amt.eight_schools_noncentered(), amt.SAConfig(num_warmup=7))
    C, W, N = 128, 7, 20
    init = k.init(torch.Generator(cuda).manual_seed(5), n_chains=C)
    out, counts = [], []
    for eager in (True, False):
        g = torch.Generator(cuda).manual_seed(6)
        k1.launches = 0
        samples, extras, last = amt.run_mcmc(
            k, g, W, N, thinning=5, n_chains=C, init_state=init,
            extra_fields=("accept_prob",), eager=eager)
        torch.cuda.synchronize()
        counts.append(k1.launches)
        out.append([samples, extras["accept_prob"], *state_tensors(last),
                    torch.rand(4, generator=g, device=cuda)])
    assert counts == [3 * (W + N)] * 2
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_checkpointed_resume_on_the_card(cuda, tmp_path):
    from adaptive_mcmc_tpu_torch.infer import run_mcmc_checkpointed
    k = amt.arwmh(amt.std_normal(3))
    want, _, _ = amt.run_mcmc(k, torch.Generator(cuda).manual_seed(1), 10,
                              60, thinning=3, n_chains=32)
    run_mcmc_checkpointed(k, torch.Generator(cuda).manual_seed(1), 10, 30,
                          thinning=3, n_chains=32, checkpoint_dir=tmp_path,
                          chunk_size=30)
    got, _, last = run_mcmc_checkpointed(
        k, torch.Generator(cuda).manual_seed(2), 10, 60, thinning=3,
        n_chains=32, checkpoint_dir=tmp_path, chunk_size=30)
    assert last.position.is_cuda
    np.testing.assert_array_equal(got, want.cpu().numpy())


def _nuts_runs(cuda, kernel, init, n_steps, n_frames, thinning):
    """step_n then collect_n from ``init``, eagerly and from the CUDA
    graph, each from a generator of the same seed: (state and frame
    tensors, the generator's next draws) per mode."""
    out = []
    for eager in (True, False):
        g = torch.Generator(cuda).manual_seed(9)
        s = kernel.step_n(init, n_steps, g, eager=eager)
        s, frames = kernel.collect_n(s, n_frames, thinning, g, eager=eager)
        torch.cuda.synchronize()
        out.append([*state_tensors(s), *frames.values(),
                    torch.rand(4, generator=g, device=cuda)])
    return out


def test_nuts_graph_run_equals_eager_run(cuda):
    k = amt.nuts(amt.eight_schools_noncentered(),
                 amt.NUTSConfig(num_warmup=30))
    init = k.init(torch.Generator(cuda).manual_seed(5), n_chains=128)
    eager, graph = _nuts_runs(cuda, k, init, 40, 10, 2)
    for a, b in zip(eager, graph):
        assert a.is_cuda and torch.equal(a, b)
    assert int(graph[0]) == 60


@pytest.mark.parametrize("n_steps", [7, 13])
def test_nuts_step_n_off_the_block_length(cuda, n_steps):
    """A call whose trips end inside a block: the trips past every chain's
    end are no-ops, and the graph still equals the eager blocks."""
    k = amt.nuts(amt.std_normal(3), amt.NUTSConfig(num_warmup=10))
    init = k.init(torch.Generator(cuda).manual_seed(3), n_chains=64)
    eager, graph = _nuts_runs(cuda, k, init, n_steps, 2, 3)
    for a, b in zip(eager, graph):
        assert torch.equal(a, b)
    assert int(graph[0]) == n_steps + 6


def test_nuts_collect_n_frames_are_each_calls_own(cuda):
    """Two graph collect_n calls in a row hand back distinct frame buffers,
    each equal to its eager run."""
    k = amt.nuts(amt.std_normal(3), amt.NUTSConfig(num_warmup=0))
    init = k.init(torch.Generator(cuda).manual_seed(4), n_chains=64)
    runs = []
    for eager in (True, False):
        g = torch.Generator(cuda).manual_seed(6)
        s, first = k.collect_n(init, 6, 2, g, eager=eager)
        _, second = k.collect_n(s, 6, 2, g, eager=eager)
        runs.append((first, second))
    (e1, e2), (g1, g2) = runs
    for f in ("position", "potential_energy"):
        assert g1[f].data_ptr() != g2[f].data_ptr()
        assert torch.equal(g1[f], e1[f]) and torch.equal(g2[f], e2[f])
        assert not torch.equal(g1[f], g2[f])


def test_nuts_potential_reading_the_host_raises_on_the_first_block(cuda):
    base = amt.std_normal(2)

    def potential(x):
        scale = float(x.abs().max().item() >= 0.0)   # a host read
        return scale * base.potential_fn(x)

    t = dataclasses.replace(base, potential_fn=potential)
    k = amt.nuts(t, amt.NUTSConfig(num_warmup=5))
    g = torch.Generator(cuda).manual_seed(1)
    init = k.init(g, n_chains=16)
    before = g.get_state()
    with pytest.raises(RuntimeError, match="cannot capture nuts.step_n"):
        k.step_n(init, 4, g)
    assert torch.equal(g.get_state(), before)
    out = k.step_n(init, 4, g, eager=True)
    assert int(out.i) == 4


def test_nuts_lockstep_step_on_the_card_matches_the_cpu(cuda):
    k = amt.nuts(amt.eight_schools_noncentered(),
                 amt.NUTSConfig(num_warmup=10, max_tree_depth=5))
    s = k.init(torch.Generator().manual_seed(2), n_chains=32)
    rng = np.random.default_rng(0)
    draws = amt.NUTSDraws(
        torch.tensor(rng.normal(size=(32, 10)), dtype=torch.float32),
        *(torch.tensor(rng.uniform(size=shape), dtype=torch.float32)
          for shape in ((32, 5), (32, 5), (32, 5, 16))))
    want = k.step(s, None, draws)
    on_card = [t.to(cuda) for t in state_tensors(s)]
    from adaptive_mcmc_tpu_torch.infer.mcmc import map_state
    it = iter(on_card)
    s_card = map_state(lambda t: next(it), s)
    got = k.step(s_card, None, amt.NUTSDraws(*(t.to(cuda) for t in draws)))
    assert torch.equal(got.num_steps.cpu(), want.num_steps)
    for a, b in zip(state_tensors(got), state_tensors(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_nuts_mcmc_runs_from_the_graph(cuda):
    t = amt.eight_schools_noncentered()
    mcmc = amt.MCMC(amt.nuts(t), num_warmup=60, num_samples=40,
                    thinning=2, n_chains=256)
    mcmc.run(torch.Generator(cuda).manual_seed(0))
    draws = mcmc.get_samples(group_by_chain=True, flat_unconstrained=True)
    assert draws.is_cuda and draws.shape == (20, 256, 10)
    assert torch.isfinite(draws).all()
    assert "Step size" in mcmc.diagnostics_str()


# -- the diagnostics: metrics, the auction's graph, sample_pnx's graph --

def _clouds_np(n, d, seed, shift=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((n, d)) + shift).astype(np.float32))


def test_auction_graph_equals_eager_and_the_cpu(cuda):
    """The batched auction from its CUDA graphs equals eager=True bit for
    bit (assignments and prices), and both equal the CPU solve of the same
    costs: every round is exact float arithmetic."""
    from adaptive_mcmc_tpu_torch.metrics import assignment as ta

    ref, _ = _clouds_np(600, 4, 0)
    costs = torch.stack([amt.metrics.minkowski_cost_matrix(
        torch.tensor(_clouds_np(600, 4, s)[1]), torch.tensor(ref))
        for s in (1, 2, 3)])
    before = profiling.totals().get("graph.replays", 0)
    cg, pg = ta.auction_assignment_batch(costs.to(cuda), return_prices=True)
    assert profiling.totals()["graph.replays"] > before
    replays = profiling.totals()["graph.replays"]
    ce, pe = ta.auction_assignment_batch(costs.to(cuda), return_prices=True,
                                         eager=True)
    assert profiling.totals()["graph.replays"] == replays
    assert torch.equal(cg, ce) and torch.equal(pg, pe)
    cc, pc = ta.auction_assignment_batch(costs, return_prices=True)
    assert torch.equal(cg.cpu(), cc) and torch.equal(pg.cpu(), pc)
    warm = ta.auction_assignment_batch(costs.to(cuda), prices_init=pg)
    assert torch.equal(warm.cpu(), ta.auction_assignment_batch(
        costs, prices_init=pc))


# (B, n, m): square 2, 64 and 625 (625: four warps per bidder at blocks 16
# and 128, with scalar loads), a rectangle, long rows (two, four and eight
# warps per bidder, float4 loads), 1 x 1
AUCTION_SHAPES = [(1, 2, 2), (8, 2, 2), (1, 64, 64), (8, 64, 64),
                  (1, 625, 625), (8, 625, 625), (8, 48, 80), (8, 32, 256),
                  (8, 64, 512), (2, 64, 4096), (1, 1, 1), (8, 1, 1)]


def _auction_pair(cuda, B, n, m, costs_kind, warm):
    """Two auctions on the same CUDA tensors' copies, at ε = range / (2n)
    (ε_final): costs uniform or integer-valued in 0..3 (dense ties, and
    benefits of -0.0), prices zero or warm (uniform over the range)."""
    from adaptive_mcmc_tpu_torch.metrics import assignment as ta

    rng = np.random.default_rng(B * 100003 + n * 101 + m)
    if costs_kind == "integer":
        costs = rng.integers(0, 4, (B, n, m)).astype(np.float32)
    else:
        costs = rng.random((B, n, m)).astype(np.float32)
    span = max(float(costs.max() - costs.min()), 1e-6)
    prices = (rng.random((B, m)) * span).astype(np.float32) if warm \
        else np.zeros((B, m), np.float32)
    pair = [ta._Auction(-torch.tensor(costs, device=cuda),
                        torch.tensor(prices, device=cuda), eager=True)
            for _ in range(2)]
    for a in pair:
        a.reset(span / (2 * n))
    return pair


def _auction_buffers(a):
    return (a.row_to_col, a.col_owner, a.prices, a.live)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("costs_kind", ["uniform", "integer"])
@pytest.mark.parametrize("block", [16, 128, 1024])
@pytest.mark.parametrize("shape", AUCTION_SHAPES,
                         ids=["x".join(map(str, s)) for s in AUCTION_SHAPES])
def test_auction_kernel_round_equals_the_plain_round(cuda, shape, block,
                                                     costs_kind, warm):
    """One kernel launch per round against the plain round on the same
    buffers' twins: row_to_col, col_owner, prices and live equal bit for bit
    after every round, up to 300 rounds or three rounds past the last
    assignment (no-op rounds).  At 1 x 1 the one bid is +inf and wins
    nothing, so nothing is ever assigned."""
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak

    kern, plain = _auction_pair(cuda, *shape, costs_kind, warm)
    before = ak.launches
    after_done = 0
    for r in range(300):
        kern.round(block)
        ak.auction_round_reference(plain.benefit, plain.prices,
                                   plain.row_to_col, plain.col_owner,
                                   plain.eps, plain.live, block)
        torch.cuda.synchronize()
        for name, x, y in zip(("row_to_col", "col_owner", "prices", "live"),
                              _auction_buffers(kern),
                              _auction_buffers(plain)):
            assert torch.equal(x, y), f"{name} differs after round {r}"
        after_done += not bool(kern.unassigned().any())
        if after_done == 3:
            break
    assert ak.launches == before + r + 1
    assert bool((kern.row_to_col[:, -1] == -1).all())
    if shape[1:] == (1, 1):
        assert bool((kern.row_to_col == -1).all()) and r == 299
        assert bool((kern.live == 300).all())


def test_auction_kernel_rounds_count_and_the_first_round_reads_nothing(
        cuda):
    """On the card every round of a solve runs through the kernel:
    auction.kernel_rounds and the kernel's launches (graph replays counted
    once per replay) equal auction.rounds, eagerly and from the graphs; the
    first round passes _NoHostRead."""
    from adaptive_mcmc_tpu_torch.infer.mcmc import _NoHostRead
    from adaptive_mcmc_tpu_torch.metrics import assignment as ta
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak

    ref, _ = _clouds_np(300, 4, 0)
    costs = torch.stack([amt.metrics.minkowski_cost_matrix(
        torch.tensor(_clouds_np(300, 4, s)[1]), torch.tensor(ref))
        for s in (1, 2)]).to(cuda)
    a = ta._Auction(-costs, torch.zeros((2, 300), device=cuda), eager=False)
    a.reset(0.01)
    with _NoHostRead():
        a.round(16)
    for eager in (False, True):
        totals = profiling.totals()
        rounds = totals.get("auction.rounds", 0)
        kernel_rounds = totals.get("auction.kernel_rounds", 0)
        launches = ak.launches
        ta.auction_assignment_batch(costs, eager=eager)
        torch.cuda.synchronize()
        totals = profiling.totals()
        ran = totals["auction.rounds"] - rounds
        assert ran > 0
        assert totals["auction.kernel_rounds"] - kernel_rounds == ran
        assert ak.launches - launches == ran


def test_auction_kernel_round_bids_nothing_from_a_row_with_no_value(cuda):
    """A benefit row of NaNs or of -infs has no best column: the kernel's
    bidder there bids on nothing and writes no index past the row, the
    other rows bid as usual, and the scratch is zero after the round."""
    from adaptive_mcmc_tpu_torch.ops.cuda import auction as ak

    B, n = 2, 64
    g = torch.Generator().manual_seed(3)
    benefit = -torch.rand((B, n, n), generator=g)
    benefit[0, 2] = float("nan")
    benefit[1, 0] = float("-inf")
    benefit = benefit.to(cuda)
    prices = torch.zeros((B, n), device=cuda)
    row_to_col = torch.full((B, n + 1), -1, dtype=torch.int64, device=cuda)
    col_owner = torch.full((B, n), -1, dtype=torch.int64, device=cuda)
    live = torch.zeros((B,), dtype=torch.int64, device=cuda)
    scratch = ak.new_scratch(B, n, n, cuda)
    ak.launch_round(benefit, prices, row_to_col, col_owner,
                    torch.tensor(0.01, device=cuda), live, 16, scratch)
    torch.cuda.synchronize()
    assert int(row_to_col[0, 2]) == -1 and int(row_to_col[1, 0]) == -1
    assert int((row_to_col[:, :16] >= 0).sum()) > 0
    assert bool(torch.isfinite(prices).all())
    assert bool((live == 1).all())
    keys, _, done = scratch
    assert bool((keys == 0).all()) and bool((done == 0).all())


def test_metrics_on_the_card_match_the_cpu(cuda):
    """Every metric on the card against the same function on the CPU, same
    arrays, rtol 1e-4."""
    from adaptive_mcmc_tpu_torch.metrics import sinkhorn as tsk
    from adaptive_mcmc_tpu_torch.metrics import sliced as tsl

    m = amt.metrics
    x, y = (torch.tensor(a) for a in _clouds_np(700, 6, 5))
    xs = torch.stack([torch.tensor(_clouds_np(700, 6, s)[1])
                      for s in (6, 7)])
    dirs = torch.randn((128, 6), generator=torch.Generator().manual_seed(0))
    pairs = [
        (lambda a, b, c, D: m.pth_moment_rmse(a, b, 1.0)),
        (lambda a, b, c, D: m.wasserstein_1d(a.T, b.T)),
        (lambda a, b, c, D: tsl.sliced_from_directions(a, b, D)),
        (lambda a, b, c, D: m.median_sq_dist(b)),
        (lambda a, b, c, D: m.mmd2_unbiased(a, b, 0.3)),
        (lambda a, b, c, D: m.mmd_heuristic(a, b)),
        (lambda a, b, c, D: m.mmd_heuristic_many(c, b)),
        (lambda a, b, c, D: m.minkowski_cost_matrix(a, b)),
        (lambda a, b, c, D: torch.tensor(m.wasserstein_sinkhorn(a, b))),
        (lambda a, b, c, D: torch.tensor(m.wasserstein_dist11_p(a, b))),
    ]
    for fn in pairs:
        want = fn(x, y, xs, dirs)
        got = fn(x.to(cuda), y.to(cuda), xs.to(cuda), dirs.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    cost = tsk._euclidean_cost(x, y)
    eps = torch.mean(cost) * 0.05
    want = tsk._solve(cost, eps, 0.05, 500)
    got = tsk._solve(cost.to(cuda), eps.to(cuda), 0.05, 500)
    assert got[4] == want[4]
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=0)


@pytest.mark.parametrize("name", ["arwmh", "sa"])
def test_sample_pnx_same_seed_same_rollout_from_the_graph(cuda, name):
    """A seeded rollout on the card: the first call runs eagerly and
    captures the graph, the second replays it; both equal eager=True, and
    another seed differs."""
    from adaptive_mcmc_tpu_torch.infer import mcmc as im

    t = amt.std_normal(2)
    k = amt.arwmh(t) if name == "arwmh" else \
        amt.sa(t, amt.SAConfig(adapt_state_size=16))
    adapt = amt.get_init_adapt_state(k, torch.Generator().manual_seed(3),
                                     position=torch.zeros(2))
    x = torch.tensor([[0.0, 0.0], [3.0, 0.0]], device=cuda)
    a = amt.sample_pnx(k, 7, x, adapt, n=5, n_samples=512)
    b = amt.sample_pnx(k, 7, x, adapt, n=5, n_samples=512)
    assert a.is_cuda and any(e.blocks is not None and e.blocks._replay
                             for e in im._ROLLOUTS.values())
    e = amt.sample_pnx(k, 7, x, adapt, n=5, n_samples=512, eager=True)
    assert torch.equal(a, b) and torch.equal(a, e)
    assert not torch.equal(a, amt.sample_pnx(k, 8, x, adapt, n=5,
                                             n_samples=512))


def _asss_runs(cuda, kernel, init, n_steps, n_frames, thinning):
    """Two step_n calls (the second replays the graph the first kept),
    then collect_n, eagerly and from the CUDA graph, each from a generator
    of the same seed: (state and frame tensors, the generator's next
    draws) per mode."""
    out = []
    for eager in (True, False):
        g = torch.Generator(cuda).manual_seed(9)
        s = kernel.step_n(init, n_steps, g, eager=eager)
        s = kernel.step_n(s, n_steps, g, eager=eager)
        s, frames = kernel.collect_n(s, n_frames, thinning, g, eager=eager)
        torch.cuda.synchronize()
        out.append([*state_tensors(s), *frames.values(),
                    torch.rand(4, generator=g, device=cuda)])
    return out


@pytest.mark.parametrize("name,C", [("eight_schools_noncentered", 256),
                                    ("diamonds", 64)])
def test_asss_machine_graph_equals_eager_blocks(cuda, name, C):
    t = getattr(amt, name)()
    k = amt.asss(t, amt.ASSSConfig(num_warmup=15))
    init = k.init(torch.Generator(cuda).manual_seed(5), n_chains=C)
    k1.launches = 0
    eager, graph = _asss_runs(cuda, k, init, 10, 6, 2)
    assert k1.launches > 0
    for a, b in zip(eager, graph):
        assert a.is_cuda and torch.equal(a, b)
    assert int(graph[0]) == 32


def test_asss_step_n_keeps_its_graph_and_a_fresh_clock(cuda):
    """A second step_n call of the same shape replays the kept graph (no
    new capture) with the state's own i: with max_shrinkage_iters=0 the
    adaptation depends on the clock alone, so two calls equal one."""
    from adaptive_mcmc_tpu_torch.ops.cuda import asss_fused as m

    k = amt.asss(amt.eight_schools_noncentered(),
                 amt.ASSSConfig(num_warmup=5, max_shrinkage_iters=0))
    s0 = k.init(torch.Generator(cuda).manual_seed(1), n_chains=64)
    g = torch.Generator(cuda).manual_seed(2)
    one = k.step_n(s0, 7, g)
    two = k.step_n(k.step_n(s0, 3, g), 4, g)
    for a, b in zip(state_tensors(one), state_tensors(two)):
        assert torch.equal(a, b)
    assert m.GRAPH_ITERS > 1


def test_asss_potential_reading_the_host_raises_on_the_first_block(cuda):
    base = amt.std_normal(2)

    def potential(x):
        scale = float(x.abs().max().item() >= 0.0)   # a host read
        return scale * base.potential_fn(x)

    t = dataclasses.replace(base, potential_fn=potential)
    k = amt.asss(t)
    g = torch.Generator(cuda).manual_seed(1)
    init = k.init(g, n_chains=16)
    before = g.get_state()
    with pytest.raises(RuntimeError, match="cannot capture asss.step_n"):
        k.step_n(init, 4, g)
    assert torch.equal(g.get_state(), before)
    assert int(k.step_n(init, 4, g, eager=True).i) == 4


def test_run_w_eval_on_the_card(cuda, tmp_path):
    from adaptive_mcmc_tpu_torch.experiments.configs import RunConfig
    from adaptive_mcmc_tpu_torch.experiments.runner import run_w_eval

    for kernel, fan in (("asss", 1), ("nuts", 4)):
        cfg = RunConfig(target="eight_schools", kernel=kernel, n_seeds=16,
                        num_warmup=200, num_samples=800, thinning=4,
                        fan_out=fan, out_dir=str(tmp_path))
        npz = run_w_eval(cfg, verbose=False)
        with np.load(npz) as d:
            assert d["samples"].shape == (16, 200, 10)
            assert np.isfinite(d["samples"]).all()
            meta = __import__("json").loads(str(d["meta"]))
        assert meta["driver"] == "collect_n"
        assert meta["config"]["fan_out"] == fan


def test_evaluate_run_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The metrics on the card against the CPU within 5.64e-5
    relative (the auction's W within its ε_final bound)."""
    import json

    from adaptive_mcmc_tpu_torch.experiments.evaluate import evaluate_run

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 300, 3)).astype(np.float32)
    npz = tmp_path / "k.npz"
    np.savez_compressed(npz, samples=x, meta=json.dumps(
        {"config": {"fan_out": 1}}))
    ref = rng.normal(size=(300, 3)).astype(np.float32)
    card = evaluate_run(npz, ref, exact_w_batch=2)
    cpu = evaluate_run(npz, ref, exact_w_batch=2, device="cpu")
    for c in ("rmse_means", "sinkhorn", "mmd", "ess_median", "ess_min"):
        np.testing.assert_allclose(card[c], cpu[c], rtol=5.64e-5, err_msg=c)
    span = float(np.linalg.norm(ref.max(0) - ref.min(0))) * 2
    np.testing.assert_allclose(card["wasserstein"], cpu["wasserstein"],
                               atol=span / 300)


# -- ASSS's lockstep step from CUDA graphs in blocks of shrinkage trips ----

def test_asss_lockstep_run_from_the_graph_equals_the_eager_blocks(cuda):
    """run_mcmc of ASSS's lockstep step (step_n=None) with adaptation at
    1024 chains from the graphs and eagerly, one seed: draws, last state
    and the generator's next draws bit for bit, K1 launched once per step
    in both."""
    t = amt.eight_schools_noncentered()
    k = dataclasses.replace(amt.asss(t, amt.ASSSConfig(num_warmup=20)),
                            step_n=None, collect_n=None)
    init = k.init(torch.Generator("cuda").manual_seed(1), n_chains=1024)
    runs = []
    for eager in (True, False):
        k1.launches = 0
        g = torch.Generator("cuda").manual_seed(2)
        s, ex, last = amt.run_mcmc(k, g, 20, 40, thinning=4, n_chains=1024,
                                   init_state=init, eager=eager,
                                   extra_fields=("as_change",))
        runs.append([s, ex["as_change"], *state_tensors(last),
                     torch.rand(4, generator=g, device="cuda"),
                     k1.launches])
    e, gr = runs
    assert e[-1] == gr[-1] == 60
    assert all(torch.equal(a, b) for a, b in zip(e[:-1], gr[:-1]))


def _rollout_devices() -> set:
    """The device types sample_pnx's rollouts ran on since the recorder
    was cleared."""
    return {k.split(".", 1)[1] for k in profiling.totals()
            if k.startswith("rollouts.")}


def test_asss_probe_and_seeded_rollout_from_the_graph(cuda):
    """probe from the graphs equals probe(eager=True); a seeded frozen-ASSS
    sample_pnx (captured, then replayed) equals its eager loop and runs
    on the card."""
    mix = amt.gaussian_mixture_1d()
    k = amt.asss(mix, amt.ASSSConfig(adapt=False))
    s0 = k.init(torch.Generator("cuda").manual_seed(0), n_chains=4096)
    a = k.probe(s0, 6, torch.Generator("cuda").manual_seed(3))
    b = k.probe(s0, 6, torch.Generator("cuda").manual_seed(3), eager=True)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0].position,
                                                   b[0].position)
    kf, adapt = amt.analysis.frozen_asss(mix, loc=1.0, device=cuda)
    x = torch.linspace(-2, 2, 20, device=cuda)[:, None]
    profiling.clear()
    g1 = amt.sample_pnx(kf, 5, x, adapt, n=4, n_samples=500)
    g2 = amt.sample_pnx(kf, 5, x, adapt, n=4, n_samples=500)
    e = amt.sample_pnx(kf, 5, x, adapt, n=4, n_samples=500, eager=True)
    assert torch.equal(g1, e) and torch.equal(g2, e)
    assert _rollout_devices() == {"cuda"}


def test_figure_data_on_the_card(cuda):
    """Two families' data at small sizes on the card: every rollout on
    the CUDA device, the theory gates of the invariance family held."""
    from adaptive_mcmc_tpu_torch.analysis import figures as tf

    profiling.clear()
    inv = tf.data_invariance(device="cuda", n=100_000)
    tf.data_x_step(device="cuda", n_samples=2000, n_points=10)
    assert _rollout_devices() == {"cuda"}
    assert all(g[3] for g in tf.theory_gates({"invariance": inv}))


# -- the recorder of spans and counters on the card ------------------------

def _inside(span, ev) -> bool:
    start = ev.start_ns()
    return span.start_ns <= start and start + ev.duration_ns() <= span.end_ns


def test_spans_share_the_device_timeline(cuda):
    """Under a CPU + CUDA profiler the recorded spans hold, on the trace's
    own clock, what ran in them: the CUDA runtime's begin and end of the
    capture in run_mcmc's graph.capture span, and the device interval of
    one K1 launch in a span closed by a synchronize (the launch before it,
    also synchronised, falls outside).  No span is drawn on the device's
    timeline, where a measure of the device's busy time would count it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k = amt.arwmh(amt.eight_schools_noncentered(),
                  amt.ARWMHConfig(num_warmup=4))
    Lt, vt, coef = _chol_inputs(512, 10, cuda)

    def run(seed):
        amt.run_mcmc(k, torch.Generator(cuda).manual_seed(seed), 4, 8,
                     thinning=4, n_chains=64)
        torch.cuda.synchronize()

    run(1)                                   # builds and warms the kernels
    k1.chol_update_cl(Lt, vt, coef)
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(2)
        k1.chol_update_cl(Lt, vt, coef)
        torch.cuda.synchronize()
        with profiling.span("k1.launch"):
            k1.chol_update_cl(Lt, vt, coef)
            torch.cuda.synchronize()
    spans = profiling.spans()
    events = prof.profiler.kineto_results.events()
    (capture,) = [s for s in spans if s.name == "graph.capture"]
    assert capture.attrs == {"label": "arwmh.step"}
    runtime = [ev for ev in events
               if ev.name().startswith(("cudaStreamBeginCapture",
                                        "cudaStreamEndCapture"))]
    assert len(runtime) == 2
    assert all(_inside(capture, ev) for ev in runtime)
    (launch,) = [s for s in spans if s.name == "k1.launch"]
    k1_device = sorted((ev for ev in events
                        if ev.device_type() == DeviceType.CUDA
                        and "chol_update_cl_kernel" in ev.name()),
                       key=lambda ev: ev.start_ns())
    assert len(k1_device) == 2
    assert [_inside(launch, ev) for ev in k1_device] == [False, True]
    names = {s.name for s in spans}
    assert not [ev.name() for ev in events
                if ev.device_type() == DeviceType.CUDA and ev.name() in names]


def test_k3_iters_counted_without_a_host_read(cuda):
    """K3's launch counts k3.steps (steps x chains) and, while tracing is
    on, k3.iters, the sum of its chains' iterations, added on the card: the
    launch makes no host sync while it is recorded, and the count read
    afterwards equals int(iters.sum()).  With tracing off it counts
    k3.steps alone."""
    from torch.profiler import ProfilerActivity, profile

    t = amt.eight_schools_noncentered()
    cfg = amt.ASSSConfig(num_warmup=8)
    C, rows, n = 256, 512, 16
    g, state = _asss_state(t, C, cuda, 0)
    unif3 = torch.rand((rows, 3, C), generator=g, device=cuda) \
        .clamp_(1e-6, 1 - 1e-6)
    n01 = torch.randn((rows, t.dim + 1, C), generator=g, device=cuda)
    k3._launch(t, cfg, state, n, 0, 1, None, unif3, n01)    # warm
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.span("k3"):
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, _, iters = k3._launch(t, cfg, state, n, 0, 1, None,
                                         unif3, n01)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    (span,) = profiling.spans()
    assert span.counts == {"k3.steps": n * C, "k3.iters": int(iters.sum())}
    assert profiling.totals() == span.counts
    assert int(iters.sum()) >= n * C
    profiling.clear()
    k3._launch(t, cfg, state, n, 0, 1, None, unif3, n01)
    assert profiling.totals() == {"k3.steps": n * C}
