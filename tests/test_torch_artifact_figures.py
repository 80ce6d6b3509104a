"""The port's artifact figures against the JAX package's
(``analysis/artifact_figures.py``): the aggregate table of the metric
boxplots byte for byte on the same eval CSVs (the port reads them as
``pd.read_csv`` does and aggregates as pandas' groupby does, without
pandas), and every family on runs that the port's own harness makes here
at n_pow 2 and tiny w_eval budgets: the same families made and skipped,
the same file names, and the reductions against numpy on the same npz
files (rtol 1e-5: float32 sums on one side, numpy's on the other)."""

import io
import shutil
from pathlib import Path
from xml.etree import ElementTree

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pd = pytest.importorskip("pandas")
pytest.importorskip("seaborn")

from adaptive_mcmc_tpu.analysis import artifact_figures as jaf  # noqa: E402
from adaptive_mcmc_tpu_torch.analysis import (  # noqa: E402
    artifact_figures as taf,
)

ROOT = Path(__file__).resolve().parents[1]
SNAPSHOT = ROOT / "mcmc_runs" / "torch_h100"
LR_CELLS = (("eight_schools_centered", "arwmh"),
            ("eight_schools_centered", "asss"), ("diamonds", "arwmh"),
            ("kidiq", "arwmh"))


def _svgs(out: Path) -> set:
    names = set()
    for f in out.glob("*.svg"):
        ElementTree.parse(f)
        names.add(f.name)
    return names


def test_parse_float_reads_what_pandas_reads():
    """The committed eval CSVs' metric strings and a spread of reprs:
    parse_float equals pd.read_csv's default parser on each (which
    differs from float() on many of them)."""
    strs = []
    for f in sorted(SNAPSHOT.glob("*/eval_*.csv")):
        strs += [s for s in pd.read_csv(f, dtype=str)[["rmse_means", "mmd"]]
                 .to_numpy().ravel() if isinstance(s, str)]
    rng = np.random.default_rng(0)
    strs += [repr(float(v)) for v in np.concatenate([
        rng.uniform(0, 1, 500), rng.lognormal(0, 6, 500), [1e-310, 5e300]])]
    strs += ["-0.5", "12", "3.25e-05", "1E+20"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(strs)))["x"].to_numpy()
    got = np.asarray([taf.parse_float(s) for s in strs])
    np.testing.assert_array_equal(got, want)
    assert np.isnan(taf.parse_float(""))


@pytest.mark.parametrize("target", ["eight_schools", "diamonds", "kidiq"])
def test_aggregate_csv_equals_jax_byte_for_byte(tmp_path, monkeypatch,
                                                target):
    """The committed H100 sweep's eval CSVs of one target (kidiq's with
    empty W cells) under a tmp run root for both packages: the aggregate
    CSV byte for byte, the boxplots under the same three names."""
    runs = tmp_path / "runs"
    (runs / "w_eval" / target).mkdir(parents=True)
    for f in (SNAPSHOT / target).glob("eval_*.csv"):
        shutil.copy(f, runs / "w_eval" / target / f.name)
    monkeypatch.setattr(jaf, "RUNS", runs)
    monkeypatch.setattr(taf, "RUNS", runs)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    out_j.mkdir()
    out_t.mkdir()
    assert jaf.fig_metric_boxplots(out_j, target)
    data = taf.data_metric_boxplots(target, device="cpu")
    taf.draw_metric_boxplots(data, target, out_t)
    name = f"eval-aggregate-{taf.FIG_TARGET[target]}.csv"
    assert (out_t / name).read_bytes() == (out_j / name).read_bytes()
    assert _svgs(out_t) == _svgs(out_j) and len(_svgs(out_t)) == 3


def test_a_family_without_artifacts_returns_none(tmp_path):
    assert taf.data_metric_boxplots("kidiq", tmp_path, "cpu") is None
    assert taf.data_lr_decay_pe("diamonds", "asss", tmp_path, "cpu") is None
    assert taf.data_kidiq_predictive(tmp_path, "cpu") is None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's harness at small sizes: four lr_decay cells at n_pow 2
    (4 seeds; diamonds and kidiq ASSS left out for time, so both packages
    skip their two families each), the eight-schools w_eval cells,
    diamonds ARWMH and kidiq NUTS at tiny budgets (2 seeds) with their
    eval CSVs, and an eight schools reference (its ARWMH draws) for the
    gold guides."""
    from adaptive_mcmc_tpu_torch.experiments import cli, configs, runner
    from adaptive_mcmc_tpu_torch.experiments.evaluate import (
        evaluate_run,
        vendored_gold_draws,
    )

    root = tmp_path_factory.mktemp("runs")
    for target, kernel in LR_CELLS:
        runner.run_lr_decay(target, kernel, n_pow=2, n_seeds=4,
                            out_dir=str(root), verbose=False, device="cpu")
    cells = [("eight_schools", "arwmh", 0.002), ("eight_schools", "asss",
                                                 0.002),
             ("eight_schools", "nuts", 0.0004), ("diamonds", "arwmh", 2e-4),
             ("kidiq", "nuts", 0.001)]
    for target, kernel, scale in cells:
        cfg = configs.RunConfig(target=target, kernel=kernel, n_seeds=2,
                                out_dir=str(root),
                                **cli._scaled_budget(target, kernel, scale))
        npz = runner.run_w_eval(cfg, verbose=False, device="cpu")
        if target == "eight_schools" and kernel == "arwmh":
            ref = np.load(npz)["samples"].reshape(-1, 10)
            (root / "reference_draws").mkdir()
            np.save(root / "reference_draws" / "eight_schools_nuts.npy", ref)
        if target != "kidiq":
            gold = vendored_gold_draws(target) if target == "diamonds" \
                else ref
            evaluate_run(npz, gold, root / "w_eval" / target
                         / f"eval_{kernel}.csv", device="cpu",
                         exact_wasserstein_seeds=1, sinkhorn=False)
    return root


def test_families_on_the_ports_runs_match_jax(runs, tmp_path, monkeypatch,
                                              capsys):
    """Both packages' main over the same run root: the same families made
    and skipped (kidiq's PE overlay for want of its gold), the same SVG
    names, each SVG valid XML, the aggregate CSVs byte for byte."""
    monkeypatch.setattr(jaf, "RUNS", runs)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    jaf.main(str(out_j))
    printed_j = capsys.readouterr().out
    made, skipped = taf.main(out_t, runs, device="cpu")
    assert capsys.readouterr().out == printed_j
    assert "kidiq-predictive" in made and "phi-diamonds" in made
    assert set(skipped) == {"metric-boxplots-kidiq", "asss-pe-lr-diamonds",
                            "asss-adaptation-lr-diamonds",
                            "arwmh-pe-lr-kidiq", "asss-pe-lr-kidiq",
                            "asss-adaptation-lr-kidiq"}
    assert _svgs(out_t) == _svgs(out_j)
    assert len(_svgs(out_t)) == 18
    for f in out_j.glob("eval-aggregate-*.csv"):
        assert (out_t / f.name).read_bytes() == f.read_bytes()


def test_family_data_against_numpy(runs):
    """The reductions of the lr_decay and φ families against numpy on the
    same npz files."""
    data = taf.data_lr_decay_adaptation("kidiq", "arwmh", runs, "cpu")
    with np.load(runs / "lr_decay" / "kidiq" / "arwmh" / "decay_0.5.npz") \
            as d:
        diffs = d["as_change"].T
        np.testing.assert_array_equal(data["ns"], d["i"])
    np.testing.assert_allclose(data["a0.5.mean"], diffs.mean(0), rtol=1e-5)
    np.testing.assert_allclose(data["a0.5.q05"],
                               np.quantile(diffs.astype(np.float64), 0.05, 0),
                               rtol=1e-5)
    pe = taf.data_lr_decay_pe("eight_schools", "arwmh", runs, "cpu")
    assert set(pe) >= {"a1.gold", "a0.5.mean", "ylim"}
    phi = taf.data_phi_convergence("eight_schools", runs, "cpu")
    with np.load(runs / "w_eval" / "eight_schools" / "asss.npz") as d:
        s = d["samples"]
    theta = s[..., :1] + np.exp(s[..., 1:2]) * s[..., 2:]
    ref = np.load(runs / "reference_draws" / "eight_schools_nuts.npy")
    ref_phi = (ref[:, :1] + np.exp(ref[:, 1:2]) * ref[:, 2:]).min(-1).mean()
    cum = np.cumsum(theta.min(-1), 1) / np.arange(1, s.shape[1] + 1) \
        - ref_phi
    np.testing.assert_allclose(phi["asss.mean"], cum.mean(0), rtol=1e-4,
                               atol=1e-5)
