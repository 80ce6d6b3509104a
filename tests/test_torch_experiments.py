"""The port's experiment harness (adaptive_mcmc_tpu_torch.experiments)
against the JAX package's: configs, budgets and the CLI's scaling; the
quadrature truths; the lr_decay summary CSV byte for byte; the CLI's
w_eval and lr_decay files; ess_columns (rtol 1e-4); the CLI's evaluate
flow and compare_wasserstein.  evaluate_run's parity is in
tests/test_torch_evaluate.py.  Everything runs on the CPU
(``device="cpu"``, CLI ``--device cpu``)."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


from adaptive_mcmc_tpu.experiments import cli as jcli  # noqa: E402
from adaptive_mcmc_tpu.experiments import configs as jcfg  # noqa: E402
from adaptive_mcmc_tpu.experiments import evaluate as jev  # noqa: E402
from adaptive_mcmc_tpu.experiments import quadrature as jquad  # noqa: E402
from adaptive_mcmc_tpu.experiments import summaries as jsum  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import cli  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import configs  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import evaluate as tev  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import quadrature  # noqa: E402
from adaptive_mcmc_tpu_torch.experiments import summaries  # noqa: E402


CELLS = sorted(configs.W_EVAL_BUDGETS)


def test_budgets_and_decays_equal_jax():
    assert configs.W_EVAL_BUDGETS == jcfg.W_EVAL_BUDGETS
    assert configs.LR_DECAYS == jcfg.LR_DECAYS
    assert len(CELLS) == 10


@pytest.mark.parametrize("scale", [1.0, 0.1, 0.001])
@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_scaled_budget_equals_jax(cell, scale):
    assert cli._scaled_budget(*cell, scale) == \
        jcli._scaled_budget(*cell, scale)


def test_scaled_budget_rwm_aliases_arwmh():
    assert cli._scaled_budget("eight_schools", "rwm", 0.1) == \
        jcli._scaled_budget("eight_schools", "rwm", 0.1)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_run_config_json_crosses_both_ways(cell):
    """The same fields and JSON; only the default out_dir differs (the
    port writes under its own root, configs.OUT_ROOT)."""
    t = configs.w_eval_config(*cell, n_seeds=7, fan_out=2, seed0=3)
    j = jcfg.w_eval_config(*cell, n_seeds=7, fan_out=2, seed0=3)
    assert t.out_dir == configs.OUT_ROOT != j.out_dir == "mcmc_runs"
    tj = configs.w_eval_config(*cell, n_seeds=7, fan_out=2, seed0=3,
                               out_dir=j.out_dir)
    assert tj.to_json() == j.to_json()
    assert configs.RunConfig.from_json(j.to_json()) == tj
    assert jcfg.RunConfig.from_json(t.to_json()) == \
        jcfg.w_eval_config(*cell, n_seeds=7, fan_out=2, seed0=3,
                           out_dir=configs.OUT_ROOT)
    assert t.run_name() == j.run_name()


def test_quadrature_truths_equal_jax():
    for got, want in ((quadrature.eight_schools_truth(),
                       jquad.eight_schools_truth()),
                      (quadrature.kidiq_truth(), jquad.kidiq_truth())):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       err_msg=k)


def test_lr_decay_summary_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    for name, seeds in (("decay_0.5.npz", 9), ("decay_1.npz", 1)):
        npz = tmp_path / name
        shape = (30, seeds) if seeds > 1 else (30,)
        np.savez_compressed(
            npz, i=np.arange(1, 31),
            position=rng.normal(size=(30, max(seeds, 1), 2)),
            potential_energy=rng.normal(size=shape).astype(np.float32),
            as_change=rng.exponential(size=shape).astype(np.float32))
        meta = {"target": "t", "kernel": "asss", "lr_decay": "0.5",
                "n_pow": 2, "wall_seconds": "1.25"}
        out = summaries.write_lr_decay_summary(npz, meta)
        ours = out.read_bytes()
        jsum.write_lr_decay_summary(npz, meta)
        assert out == jsum.summary_path_for(npz) == tmp_path / name \
            .replace("decay_", "summary_").replace(".npz", ".csv")
        assert out.read_bytes() == ours
        m1, c1 = summaries.read_lr_decay_summary(out)
        m2, c2 = jsum.read_lr_decay_summary(out)
        assert m1 == m2 and c1.keys() == c2.keys()
        for k in c2:
            np.testing.assert_array_equal(c1[k], c2[k])
    assert summaries.SUMMARY_COLUMNS == jsum.SUMMARY_COLUMNS
    assert summaries.read_lr_decay_summary(tmp_path / "none.csv") is None


def test_cli_w_eval_files_match_jax_and_skip(tmp_path, capsys):
    args = ["w_eval", "--target", "eight_schools", "--kernel", "arwmh",
            "--seeds", "8", "--scale", "0.001"]
    cli.main(args + ["--out-dir", str(tmp_path / "t"), "--device", "cpu"])
    jcli.main(args + ["--out-dir", str(tmp_path / "j")])
    paths = [tmp_path / s / "w_eval" / "eight_schools" / "arwmh.npz"
             for s in ("t", "j")]
    with np.load(paths[0]) as t, np.load(paths[1]) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].shape == j[k].shape, k
            assert t[k].dtype.kind == j[k].dtype.kind, k
        assert t["samples"].shape == (8, 10, 10)
        assert np.isfinite(t["samples"]).all()
        mt, mj = json.loads(str(t["meta"])), json.loads(str(j["meta"]))
    assert mt.keys() == mj.keys()
    assert {k: v for k, v in mt["config"].items() if k != "out_dir"} == \
        {k: v for k, v in mj["config"].items() if k != "out_dir"}
    assert mt["driver"] == mj["driver"] == "lockstep"
    assert (paths[0].parent / "manifest.json").read_text() == \
        (paths[1].parent / "manifest.json").read_text()
    capsys.readouterr()
    before = paths[0].stat().st_mtime_ns
    cli.main(args + ["--out-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert "[skip]" in capsys.readouterr().out
    assert paths[0].stat().st_mtime_ns == before


@pytest.mark.parametrize("kernel,scale", [("arwmh", 0.001),
                                          ("asss", 0.0004)])
def test_w_eval_draws_equal_the_direct_drive(tmp_path, kernel, scale):
    """run_w_eval's npz holds, bit for bit, what run_mcmc_sharded gives
    when driven directly with the same kernel, seed and budget, pooled by
    hand into (seeds, draws, ...): the harness neither drops nor
    reorders a draw (chip_smoke.py holds the diamonds cells so)."""
    import adaptive_mcmc_tpu_torch as amt
    from adaptive_mcmc_tpu_torch.experiments import runner
    from adaptive_mcmc_tpu_torch.parallel import run_mcmc_sharded

    cfg = configs.RunConfig(target="eight_schools", kernel=kernel,
                            n_seeds=3, seed0=5, out_dir=str(tmp_path),
                            **cli._scaled_budget("eight_schools", kernel,
                                                 scale))
    with np.load(runner.run_w_eval(cfg, verbose=False, device="cpu")) as d:
        got = {k: d[k] for k in ("samples", "potential_energy")}
    target = amt.eight_schools_noncentered()
    k = amt.arwmh(target, amt.ARWMHConfig(
        lr_decay=cfg.lr_decay, num_warmup=cfg.num_warmup, adapt=True)) \
        if kernel == "arwmh" else amt.asss(target, amt.ASSSConfig(
            lr_decay=cfg.lr_decay, num_warmup=cfg.num_warmup))
    samples, extras, _ = run_mcmc_sharded(
        k, torch.Generator("cpu").manual_seed(5), cfg.num_warmup,
        cfg.num_samples, thinning=cfg.thinning, n_chains=3,
        extra_fields=("potential_energy", "as_change"))
    draws = cfg.num_samples // cfg.thinning
    assert got["samples"].shape == (3, draws, 10)
    np.testing.assert_array_equal(got["samples"],
                                  samples.transpose(0, 1).numpy())
    np.testing.assert_array_equal(
        got["potential_energy"],
        extras["potential_energy"].transpose(0, 1).numpy())


def test_cli_lr_decay_matches_jax(tmp_path):
    args = ["lr_decay", "--target", "eight_schools_centered", "--kernel",
            "asss", "--n-pow", "2", "--seeds", "4"]
    cli.main(args + ["--out-dir", str(tmp_path / "t"), "--device", "cpu"])
    jcli.main(args + ["--out-dir", str(tmp_path / "j")])
    bases = [tmp_path / s / "lr_decay" / "eight_schools_centered" / "asss"
             for s in ("t", "j")]
    names = [sorted(p.name for p in b.iterdir()) for b in bases]
    assert names[0] == names[1] and len(names[0]) == 7
    for tag in ("1", "0.6667", "0.5"):
        with np.load(bases[0] / f"decay_{tag}.npz") as t, \
                np.load(bases[1] / f"decay_{tag}.npz") as j:
            assert sorted(t.files) == sorted(j.files)
            for k in t.files:
                assert t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t["i"], j["i"])
        mt, ct = summaries.read_lr_decay_summary(
            bases[0] / f"summary_{tag}.csv")
        mj, cj = jsum.read_lr_decay_summary(bases[1] / f"summary_{tag}.csv")
        assert ct.keys() == cj.keys() and mt.keys() == mj.keys()
        np.testing.assert_array_equal(ct["i"], cj["i"])


def test_cli_default_out_dir_leaves_the_jax_evidence_alone(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """With no --out-dir, w_eval, lr_decay and evaluate neither skip on
    nor write over the JAX package's tracked evidence under mcmc_runs/
    (copied into a fresh working directory, with an npz beside the w_eval
    manifest as a finished run leaves it): they write under OUT_ROOT."""
    import shutil

    repo = Path(__file__).resolve().parents[1]
    jax_files = {}
    for rel in ("mcmc_runs/w_eval/eight_schools",
                "mcmc_runs/lr_decay/eight_schools_centered/arwmh"):
        shutil.copytree(repo / rel, tmp_path / rel)
    (tmp_path / "mcmc_runs/w_eval/eight_schools/arwmh.npz").write_bytes(
        b"the reference's run")
    # a reference cache of each package's: the port must read its own
    rng = np.random.default_rng(0)
    (tmp_path / "mcmc_runs/reference_draws").mkdir()
    np.save(tmp_path / "mcmc_runs/reference_draws/eight_schools_asss.npy",
            np.full((7, 10), np.nan))
    ref = rng.normal(size=(200, 10))
    (tmp_path / configs.OUT_ROOT / "reference_draws").mkdir(parents=True)
    np.save(tmp_path / configs.OUT_ROOT /
            "reference_draws/eight_schools_asss.npy", ref)
    (tmp_path / configs.OUT_ROOT / "reference_draws/eight_schools_asss.json"
     ).write_text(json.dumps(tev.reference_settings(
         200, n_chains=50, num_warmup=2000, thinning=20, rng_seed=999)))
    for f in (tmp_path / "mcmc_runs").rglob("*"):
        if f.is_file() and configs.OUT_ROOT not in str(f):
            jax_files[f] = f.read_bytes()
    monkeypatch.chdir(tmp_path)
    w_eval = ["w_eval", "--target", "eight_schools", "--kernel", "arwmh",
              "--seeds", "4", "--scale", "0.001", "--device", "cpu"]
    cli.main(w_eval)
    cli.main(["lr_decay", "--target", "eight_schools_centered", "--kernel",
              "arwmh", "--n-pow", "2", "--seeds", "4", "--device", "cpu"])
    cli.main(["evaluate", "--target", "eight_schools", "--kernel", "arwmh",
              "--ref-kernel", "asss", "--ref-draws", "200",
              "--device", "cpu"])
    assert "[skip]" not in capsys.readouterr().out
    for f, b in jax_files.items():
        assert f.read_bytes() == b, f
    root = tmp_path / configs.OUT_ROOT
    with np.load(root / "w_eval/eight_schools/arwmh.npz") as d:
        assert d["samples"].shape == (4, 10, 10)
    df = pd.read_csv(root / "w_eval/eight_schools/eval_arwmh.csv")
    assert len(df) == 4 and np.isfinite(df["wasserstein"]).all()
    assert len(list((root / "lr_decay/eight_schools_centered/arwmh")
                    .glob("summary_*.csv"))) == 3
    new = {f for f in (tmp_path / "mcmc_runs").rglob("*") if f.is_file()}
    assert {f for f in new - set(jax_files)
            if root not in f.parents} == set()


def test_gold_spread_grades_one_run_against_each_reference(tmp_path,
                                                           monkeypatch):
    """gold_spread: the cell run as the sweep runs it, then one row per
    reference seed, each the sweep's metric_stats of evaluate_run against
    that seed's reference (its own cache directory), and the spread of the
    means."""
    from adaptive_mcmc_tpu_torch.experiments import gold_spread, sweep

    made = {}

    def fake_reference(target, n_draws=0, *, rng_seed, cache_dir, **kw):
        made[rng_seed] = Path(cache_dir).name
        if kw:            # gold_spread's call: the sweep's settings
            assert {"n_draws": n_draws, "rng_seed": tev.REFERENCE_RUN[
                "rng_seed"], **{k: kw[k] for k in (
                    "n_chains", "num_warmup", "thinning")}} \
                == tev.REFERENCE_RUN
        return np.random.default_rng(rng_seed).normal(size=(60, 10))

    monkeypatch.setattr(gold_spread, "make_reference_draws", fake_reference)
    got = gold_spread.main(["--target", "eight_schools", "--kernels",
                            "arwmh", "--ref-seeds", "3,4", "--scale",
                            "0.001", "--seeds", "4", "--exact-w-seeds", "2",
                            "--out-dir", str(tmp_path), "--device", "cpu"])
    assert made == {3: "seed_3", 4: "seed_4"}
    npz = tmp_path / "w_eval" / "eight_schools" / "arwmh.npz"
    with np.load(npz) as d:
        assert d["samples"].shape == (4, 10, 10)
    got = got["eight_schools|arwmh"]
    for seed in (3, 4):
        want = sweep.metric_stats(tev.evaluate_run(
            npz, fake_reference("", 0, rng_seed=seed, cache_dir="x"),
            exact_wasserstein_seeds=2, exact_w_batch=sweep.EXACT_W_BATCH,
            hungarian_check_seeds=0, sinkhorn=False, device="cpu"))
        assert got["rows"][seed] == want
    for m in ("rmse", "w", "mmd"):
        means = [got["rows"][s][f"{m}_mean"] for s in (3, 4)]
        assert got["spread"][m] == max(means) - min(means)


@pytest.mark.parametrize("fan_out", [1, 16])
def test_ess_columns_match_jax(fan_out):
    rng = np.random.default_rng(fan_out)
    x = np.cumsum(rng.normal(size=(3, 320, 4)), axis=1).astype(np.float32)
    x = 0.1 * x + rng.normal(size=x.shape).astype(np.float32)
    got = tev.ess_columns(x, fan_out)
    want = jev.ess_columns(x, fan_out)
    assert got.dtype == want.dtype and got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cli_evaluate_with_asss_reference(tmp_path, capsys):
    """tests/test_experiments.py's smoke flow on the port: w_eval, then
    evaluate against an ASSS reference of 1000 draws."""
    out = ["--out-dir", str(tmp_path), "--device", "cpu"]
    cli.main(["w_eval", "--target", "eight_schools", "--kernel", "arwmh",
              "--seeds", "8", "--scale", "0.001"] + out)
    cli.main(["evaluate", "--target", "eight_schools", "--kernel", "arwmh",
              "--ref-kernel", "asss", "--ref-draws", "1000"] + out)
    printed = capsys.readouterr().out
    assert "mean" in printed and "std" in printed
    df = pd.read_csv(tmp_path / "w_eval" / "eight_schools" / "eval_arwmh.csv")
    assert set(df.columns) >= {"rng_seed", "rmse_means", "wasserstein",
                               "mmd"}
    assert len(df) == 8 and np.isfinite(df["wasserstein"]).all()
    ref = np.load(tmp_path / "reference_draws" / "eight_schools_asss.npy")
    assert ref.shape == (1000, 10)


def test_compare_wasserstein_tiny(tmp_path):
    from adaptive_mcmc_tpu_torch.experiments.compare_wasserstein import run

    rows = run(ns=(30, 60), ds=(3,), out_csv=tmp_path / "cw.csv",
               device="cpu")
    df = pd.read_csv(tmp_path / "cw.csv")
    assert list(df.columns) == ["algorithm", "n", "d", "seconds", "value"]
    assert len(df) == len(rows) == 18 and df["value"].notna().all()
    h = df[(df.algorithm == "hungarian") & (df.n == 60)]["value"].iloc[0]
    a = df[(df.algorithm == "auction") & (df.n == 60)]["value"].iloc[0]
    assert abs(h - a) / h < 0.05


def test_entry_points_refuse_to_run_on_the_cpu_unasked(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["w_eval", "--target", "eight_schools", "--kernel",
                  "arwmh", "--seeds", "2", "--scale", "0.001",
                  "--out-dir", str(tmp_path)])
    assert not (tmp_path / "w_eval" / "eight_schools" / "arwmh.npz").exists()
