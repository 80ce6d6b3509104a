"""The experiment harness through the fused kernels: ``build_kernel(fused=
True)`` reaches K2's and K3's plain versions on the CPU, a w_eval cell
through them stamps the fused driver and equals a direct
``run_mcmc_sharded`` with the same kernel bit for bit, NUTS and SA refuse
``fused=True``; the sweep's ``--fused`` and reference cache, the lr_decay
family (``experiments.lr_sweep``) with its stamp, and the kidiq moments
parity against the JAX sweep's table.  Everything runs on the CPU."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import adaptive_mcmc_tpu_torch as amt  # noqa: E402
from adaptive_mcmc_tpu.experiments import configs as jcfg  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import cli  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import configs  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import evaluate as tev  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import lr_sweep  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import moments_parity  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import runner  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import summaries  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import sweep  # noqa: E402
from adaptive_mcmc_tpu_torch.ops.cuda import arwmh_fused, asss_fused  # noqa: E402,E501
from adaptive_mcmc_tpu_torch.parallel import run_mcmc_sharded  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
STAMP = {"arwmh": "collect_n:K2", "asss": "collect_n:K3"}


@pytest.mark.parametrize("kernel", ["arwmh", "asss"])
def test_build_kernel_fused_reaches_the_plain_versions(kernel, monkeypatch):
    """fused=True at d = 26 (past the auto-pick's d <= 16 for ARWMH): the
    kernel's step_n runs the fused kernel's plain version on the CPU."""
    module, name = {"arwmh": (arwmh_fused, "fused_arwmh_reference"),
                    "asss": (asss_fused, "fused_asss_reference")}[kernel]
    plain = getattr(module, name)
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    k = runner.build_kernel(kernel, amt.diamonds(), lr_decay=2 / 3,
                            num_warmup=2, fused=True)
    assert k.config.fused is True
    g = torch.Generator().manual_seed(0)
    k.step_n(k.init(g, n_chains=2), 3, g)
    assert calls
    assert runner._driver_name(k) == STAMP[kernel]
    default = runner.build_kernel(kernel, amt.diamonds(), lr_decay=2 / 3,
                                  num_warmup=2)
    assert default.config.fused is False
    assert runner._driver_name(default) in ("lockstep", "collect_n")


@pytest.mark.parametrize("kernel", ["arwmh", "asss"])
def test_fused_none_is_stamped_as_the_kernel_it_resolves_to(kernel,
                                                            monkeypatch):
    """fused=None where a card is present and AMT_*_FUSED=1 builds K2 / K3:
    the kernel's config holds the resolved True, and the w_eval stamp names
    the fused kernel, not the ASSS machine's collect_n."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("AMT_ASSS_FUSED", "1")
    monkeypatch.setenv("AMT_ARWMH_FUSED", "1")
    k = runner.build_kernel(kernel, amt.eight_schools_noncentered(),
                            lr_decay=2 / 3, num_warmup=2, fused=None)
    assert k.config.fused is True
    assert runner._driver_name(k) == STAMP[kernel]


@pytest.mark.parametrize("kernel", ["nuts", "sa", "rwm"])
def test_fused_true_raises_without_a_fused_kernel(kernel):
    with pytest.raises(ValueError, match="no fused kernel"):
        runner.build_kernel(kernel, amt.eight_schools_noncentered(),
                            lr_decay=2 / 3, num_warmup=10, fused=True)
    runner.build_kernel(kernel, amt.eight_schools_noncentered(),
                        lr_decay=2 / 3, num_warmup=10, fused=False)


@pytest.mark.parametrize("kernel", ["arwmh", "asss"])
def test_fused_w_eval_equals_the_direct_drive(tmp_path, kernel):
    """A 4-seed run_w_eval through K2 / K3 (plain versions) stamps the
    fused driver and holds, bit for bit, what run_mcmc_sharded gives with
    the same fused kernel, seed and budget."""
    cfg = configs.RunConfig(target="kidiq", kernel=kernel, n_seeds=4,
                            seed0=3, out_dir=str(tmp_path), fused=True,
                            **cli._scaled_budget("kidiq", kernel, 0.002))
    with np.load(runner.run_w_eval(cfg, verbose=False, device="cpu")) as d:
        got = {k: d[k] for k in ("samples", "potential_energy")}
        meta = json.loads(str(d["meta"]))
    assert meta["driver"] == STAMP[kernel]
    assert meta["config"]["fused"] is True
    k = runner.build_kernel(kernel, amt.kidiq(), lr_decay=cfg.lr_decay,
                            num_warmup=cfg.num_warmup, fused=True)
    samples, extras, _ = run_mcmc_sharded(
        k, torch.Generator("cpu").manual_seed(3), cfg.num_warmup,
        cfg.num_samples, thinning=cfg.thinning, n_chains=4,
        max_steps_per_call=500_000,
        extra_fields=("potential_energy", "as_change"))
    assert got["samples"].shape == (4, cfg.num_samples // cfg.thinning, 4)
    np.testing.assert_array_equal(got["samples"],
                                  samples.transpose(0, 1).numpy())
    np.testing.assert_array_equal(
        got["potential_energy"],
        extras["potential_energy"].transpose(0, 1).numpy())


def test_fused_config_json():
    """fused=True is written and read back; at its default the JSON is the
    JAX package's (test_torch_experiments holds that for every cell)."""
    c = configs.w_eval_config("diamonds", "asss", fused=True)
    assert json.loads(c.to_json())["fused"] is True
    assert configs.RunConfig.from_json(c.to_json()) == c
    d = configs.w_eval_config("diamonds", "asss", out_dir="mcmc_runs")
    assert d.to_json() == jcfg.w_eval_config("diamonds", "asss").to_json()


def test_sweep_fused_names_kernels_or_cells():
    """One ``--fused`` parser for the sweep and lr_sweep: a set of kernels
    or cells, none by default."""
    import argparse

    ap = argparse.ArgumentParser()
    sweep.add_fused_arg(ap)
    assert ap.parse_args([]).fused == frozenset()
    assert ap.parse_args(["--fused", "asss,diamonds/arwmh"]).fused == {
        "asss", "diamonds/arwmh"}
    fused = {"asss", "diamonds/arwmh"}
    assert sweep.is_fused(fused, "kidiq", "asss") is True
    assert sweep.is_fused(fused, "diamonds", "arwmh") is True
    assert sweep.is_fused(fused, "kidiq", "arwmh") is None
    assert sweep.is_fused(set(), "diamonds", "nuts") is None
    cfg = sweep.cell_config("diamonds", "asss", 0.001, 4, "o", True)
    assert cfg.fused is True and cfg.fan_out == 1


def test_sweep_grades_against_the_cached_reference_beside_the_state(
        tmp_path, capsys):
    """A fused kidiq cell: the reference comes from reference_draws/ beside
    the state file (not rebuilt), and the row stamps driver and
    reference."""
    state = tmp_path / "st" / "results_state.json"
    ref_dir = state.parent / "reference_draws"
    ref_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    np.save(ref_dir / "kidiq_nuts.npy",
            rng.normal(size=(400, 4)).astype(np.float32))
    (ref_dir / "kidiq_nuts.json").write_text(json.dumps(
        tev.reference_settings(**tev.REFERENCE_RUN)))
    sweep.main(["--targets", "kidiq", "--kernels", "asss", "--seeds", "2",
                "--scale", "kidiq/asss=0.002", "--exact-w-seeds", "1",
                "--fused", "asss", "--state", str(state),
                "--out-dir", str(tmp_path / "o"), "--device", "cpu"])
    row = json.loads(state.read_text())["kidiq|asss"]
    assert row["driver"] == "collect_n:K3" and row["reference"] == "nuts"
    assert row["n_seeds"] == 2 and row["exact_w_seeds"] == 1
    assert (state.parent / "kidiq" / "eval_asss.csv").exists()
    assert sorted(p.name for p in ref_dir.iterdir()) == ["kidiq_nuts.json",
                                                         "kidiq_nuts.npy"]


@pytest.mark.parametrize("stamp", ["other", "absent"])
def test_reference_cache_of_other_settings_raises(tmp_path, stamp):
    """make_reference_draws reuses a cache only where its settings file
    names the settings asked for: one of another seed, or none, raises
    rather than grade against the wrong run."""
    np.save(tmp_path / "kidiq_nuts.npy", np.zeros((10, 4), np.float32))
    if stamp == "other":
        (tmp_path / "kidiq_nuts.json").write_text(json.dumps(
            tev.reference_settings(**{**tev.REFERENCE_RUN,
                                      "rng_seed": 1000})))
    with pytest.raises(ValueError, match="another cache_dir"):
        tev.make_reference_draws("kidiq", kernel_name="nuts",
                                 **tev.REFERENCE_RUN,
                                 cache_dir=str(tmp_path), device="cpu")
    (tmp_path / "kidiq_nuts.json").write_text(json.dumps(
        tev.reference_settings(**tev.REFERENCE_RUN)))
    got = tev.make_reference_draws("kidiq", kernel_name="nuts",
                                   **tev.REFERENCE_RUN,
                                   cache_dir=str(tmp_path), device="cpu")
    assert got.shape == (10, 4) and not got.any()


def test_committed_kidiq_reference_carries_the_sweep_settings():
    """The committed kidiq NUTS reference is stamped with REFERENCE_RUN,
    so the sweep and moments_parity reuse it and nothing else does."""
    ref = REPO / "mcmc_runs" / "torch_h100" / "reference_draws"
    got = tev.make_reference_draws("kidiq", kernel_name="nuts",
                                   **tev.REFERENCE_RUN, cache_dir=str(ref),
                                   device="cpu")
    assert got.shape == (10_000, 4) and got.dtype == np.float32


def test_lr_sweep_runs_the_family_through_k2_k3(tmp_path, capsys):
    """One target, both kernels, n_pow 2: every decay's summary is copied
    to the summaries root, stamped with the fused step_n driver, with a
    wall and a tail printed per decay."""
    lr_sweep.main(["--targets", "kidiq", "--n-pow", "2", "--seeds", "3",
                   "--fused", "arwmh,asss",
                   "--out-dir", str(tmp_path / "o"),
                   "--summaries", str(tmp_path / "s"), "--device", "cpu"])
    out = capsys.readouterr().out
    for kernel, stamp in (("arwmh", "step_n:K2"), ("asss", "step_n:K3")):
        for tag in ("1", "0.6667", "0.5"):
            meta, cols = summaries.read_lr_decay_summary(
                tmp_path / "s" / "kidiq" / kernel / f"summary_{tag}.csv")
            assert meta["driver"] == stamp and meta["n_seeds"] == "3"
            assert meta["n_pow"] == "2" and cols["i"][-1] == 100
            assert np.isfinite(cols["as_change_mean"]).all()
            assert f"kidiq/{kernel} decay {tag}: {stamp}" in out
    # no --fused: the default drivers, no stamp
    lr_sweep.main(["--targets", "kidiq", "--kernels", "arwmh", "--n-pow",
                   "1", "--seeds", "2",
                   "--out-dir", str(tmp_path / "o2"),
                   "--summaries", str(tmp_path / "s2"), "--device", "cpu"])
    meta, _ = summaries.read_lr_decay_summary(
        tmp_path / "s2" / "kidiq" / "arwmh" / "summary_1.csv")
    assert "driver" not in meta


def _jax_parity_row():
    spec = importlib.util.spec_from_file_location(
        "_jax_full_sweeps", REPO / "scripts" / "run_full_sweeps.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._quadrature_parity_row


def test_kidiq_parity_matches_the_jax_sweep_table(tmp_path):
    """The same pooled draws through moments_parity and through the JAX
    sweep's moments-parity table agree to the table's three decimals."""
    from adaptive_mcmc_tpu_torch.experiments.quadrature import kidiq_truth

    tr = kidiq_truth()
    mean = np.concatenate([tr["mean_beta"], [tr["mean_log_sigma"]]])
    sd = np.concatenate([tr["sd_beta"], [tr["sd_log_sigma"]]])
    rng = np.random.default_rng(5)
    samples = (mean + sd * (0.1 + rng.normal(size=(3, 500, 4))
                            * [1.0, 0.95, 1.05, 1.0])).astype(np.float32)
    d = tmp_path / "w_eval" / "kidiq"
    d.mkdir(parents=True)
    np.savez(d / "arwmh.npz", samples=samples)
    line = _jax_parity_row()(str(tmp_path)).splitlines()[-1]
    _, _, zerr, ratio, _ = (c.strip() for c in line.split("|"))
    r = moments_parity.kidiq_parity(samples)
    assert f"{r['max_mean_err_sd']:.3f}" == zerr
    assert f"[{r['sd_ratio_min']:.3f}, {r['sd_ratio_max']:.3f}]" == ratio
    assert r["n_draws"] == 1500
    rows = moments_parity.main(["--refs", "", "--runs", str(d),
                                "--out", str(tmp_path / "p.json")])
    assert json.loads((tmp_path / "p.json").read_text()) == rows
    assert rows["pooled/arwmh"] == r


def test_moments_parity_reference_settings_and_draws(tmp_path, monkeypatch):
    """moments_parity builds its references at REFERENCE_RUN, each of
    --n-chains, --num-warmup, --thinning and --rng-seed overriding one
    setting, and checks --draws files as they are."""
    made = []

    def fake_reference(target, *, kernel_name, cache_dir, device, **run):
        made.append(run)
        return np.zeros((10, 4), np.float32)

    monkeypatch.setattr(tev, "make_reference_draws", fake_reference)
    draws = np.random.default_rng(2).normal(size=(50, 4)).astype(np.float32)
    np.save(tmp_path / "other.npy", draws)
    rows = moments_parity.main(["--refs", "asss", "--num-warmup", "30000",
                                "--thinning", "100",
                                "--draws", str(tmp_path / "other.npy")])
    assert made == [{**tev.REFERENCE_RUN, "num_warmup": 30000,
                     "thinning": 100}]
    assert rows["draws/other.npy"] == moments_parity.kidiq_parity(draws)
    moments_parity.main(["--refs", "nuts", "--n-chains", "50",
                         "--rng-seed", "7"])
    assert made[-1] == {**tev.REFERENCE_RUN, "n_chains": 50, "rng_seed": 7}
