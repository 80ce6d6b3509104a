"""BENCHMARK.json against its required form, every entry resolving to
its files by name, and a new cell, traffic mix, limits file and per-layer
metric added as files alone, as is a new configuration with its
reference potential and operation count."""

from __future__ import annotations

import json
import re
import subprocess
import sys

from conftest import ROOT, run_cell

from benchmark.registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / SPEC["command"][1]).is_file()


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            seen_key = (group in ("end_to_end", "per_layer"), e["name"])
            assert seen_key not in seen
            seen.add(seen_key)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_every_entry_resolves():
    reg = Registry(ROOT)
    for c in SPEC["configs"]:
        cfg = reg.config(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        t = reg.traffic(w["traffic"])
        assert callable(reg.job_module(t["kind"]).Job)
        limits = reg.limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())
        if "step_count" in t:
            assert callable(reg.counts(t["step_count"]).window_ops)
        e2e = {m["name"] for m in reg.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reg.per_layer(w["name"])
    for m in SPEC["per_layer"]:
        assert callable(reg.layer_metric(m["name"]).read)


def test_budgets_match_the_configuration():
    """A traffic mix runs the budget its configuration states."""
    reg = Registry(ROOT)
    for w in SPEC["workloads"]:
        t, cfg = reg.traffic(w["traffic"]), reg.config(w["config"])
        if t["kind"] == "sample":
            for k in ("num_warmup", "num_samples", "thinning"):
                assert t[k] == cfg[t["kernel"]][k]
        else:
            assert t["draws"] == cfg["grade"]["draws"]
            assert t["sets"] == cfg["grade"]["sets"]


def test_a_cell_and_a_metric_added_as_files(tiny_root):
    """A new traffic mix, limits file and per-layer metric are new files;
    BENCHMARK.json gains entries; no file already there changes."""
    before = {p: p.read_bytes() for p in (tiny_root / "benchmark").rglob("*")
              if p.is_file()}
    bench = tiny_root / "benchmark"
    t = json.loads((bench / "traffic" / "arwmh_k1.c4096.json").read_text())
    t["chains"] = 32
    (bench / "traffic" / "arwmh_k1.c32.json").write_text(json.dumps(t))
    (bench / "limits" / "eight_schools_noncentered.arwmh_k1.c32.json"
     ).write_text((bench / "limits" /
                   "eight_schools_noncentered.arwmh_k1.c4096.json"
                   ).read_text())
    (bench / "layer_metrics" / "jobs_traced.py").write_text(
        "def read(ctx):\n    return ctx.traced_work.get('jobs')\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({
        "name": "eight_schools_noncentered.arwmh_k1.c32",
        "config": "eight_schools_noncentered", "traffic": "arwmh_k1.c32",
        "chips": 1, "why": "a cell added by files alone"})
    spec["end_to_end"][0]["workloads"].append(
        "eight_schools_noncentered.arwmh_k1.c32")
    spec["per_layer"].append({
        "name": "jobs_traced", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "device (H100)",
        "moves": "chain_iters_per_s",
        "workloads": ["eight_schools_noncentered.arwmh_k1.c32"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(tiny_root, "eight_schools_noncentered.arwmh_k1.c32",
                   trace=1)
    assert out["metrics"]["jobs_traced"]["value"] >= 1
    out = run_cell(tiny_root, "eight_schools_noncentered.arwmh_k1.c32")
    assert out["correct"] and out["metrics"]["chain_iters_per_s"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


# the centered eight schools as a test adds it: the float64 potential in the
# port's term order (models/targets.py eight_schools_centered), and the
# count of one evaluation as csrc/common.cuh's EightSchoolsCentered does it
CENTERED_REFERENCE = '''\
"""Eight schools, centered: x = [mu, log tau, theta(8)]."""

import math

import numpy as np
import torch

from benchmark.reference.potentials import LOG_2PI, const, normal, total


def raw(config):
    return {k: np.asarray(config[k], np.float64) for k in ("y", "sigma")}


def potential(x, config):
    data = const(config, x)
    y, sigma = data["y"], data["sigma"]
    mu, log_tau, theta = x[:, 0], x[:, 1], x[:, 2:]
    tau = torch.exp(log_tau)
    zt = (theta - mu[:, None]) / tau[:, None]
    z = (y - theta) / sigma
    terms = [normal(mu, 0.0, 5.0),
             math.log(2.0 / (math.pi * 5.0)) - torch.log1p((tau / 5.0) ** 2),
             log_tau,
             torch.sum(-0.5 * (zt * zt + LOG_2PI) - log_tau[:, None], dim=1),
             torch.sum(-0.5 * (z * z + LOG_2PI) - torch.log(sigma), dim=1)]
    return total(terms)
'''
CENTERED_OPS = "POTENTIAL_OPS = 143   # 14 + log tau + 16 per school\n"

# run from the copy alone: its own benchmark package first on the path, the
# port after it
RUN_COPY = '''\
import json, sys
sys.path[:0] = [%(root)r, %(repo)r]
import benchmark
from benchmark import run
from benchmark.registry import Registry
assert benchmark.__file__.startswith(%(root)r), benchmark.__file__
reg = Registry(%(root)r)
print(json.dumps({
    "k2": reg.counts("k2").step_ops("eight_schools_centered", 10),
    "arwmh_step": reg.counts("arwmh_step").step_ops(
        "eight_schools_centered", 10)}))
run.main(["--workload", %(cell)r, "--seed", "2147483653", "--seconds",
          "0.2", "--trace", "0"], device="cpu")
'''


def test_a_configuration_added_as_files(tiny_root):
    """A configuration whose target has no reference file in the repo
    (centered eight schools) enters by new files alone: its configuration,
    reference potential and operation count, a traffic mix and a limits
    file, and BENCHMARK.json's entries.  Its cell runs correct from the
    copy, and no file already there changes."""
    before = {p: p.read_bytes() for p in (tiny_root / "benchmark").rglob("*")
              if p.is_file()}
    bench = tiny_root / "benchmark"
    cfg = json.loads((bench / "configs" / "eight_schools_noncentered.json"
                      ).read_text())
    cfg.update(name="eight_schools_centered", target="eight_schools_centered",
               model="mu ~ N(0, 5), tau ~ HalfCauchy(5), theta ~ N(mu, tau),"
                     " y_j ~ N(theta_j, sigma_j), in [mu, log tau, theta(8)]")
    (bench / "configs" / "eight_schools_centered.json").write_text(
        json.dumps(cfg))
    (bench / "reference" / "targets" / "eight_schools_centered.py"
     ).write_text(CENTERED_REFERENCE)
    (bench / "counts" / "targets" / "eight_schools_centered.py").write_text(
        CENTERED_OPS)
    t = json.loads((bench / "traffic" / "arwmh_k1.c4096.json").read_text())
    t["chains"] = 256
    (bench / "traffic" / "arwmh_k1.c256.json").write_text(json.dumps(t))
    cell = "eight_schools_centered.arwmh_k1.c256"
    (bench / "limits" / f"{cell}.json").write_text(
        (bench / "limits" / "eight_schools_noncentered.arwmh_k1.c4096.json"
         ).read_text())
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "eight_schools_centered",
        "source": "https://github.com/stan-dev/posteriordb",
        "file": "benchmark/configs/eight_schools_centered.json",
        "reduced": ["arwmh"], "why": "a configuration added by files alone"})
    spec["workloads"].append({
        "name": cell, "config": "eight_schools_centered",
        "traffic": "arwmh_k1.c256", "chips": 1,
        "why": "a cell of a configuration added by files alone"})
    spec["end_to_end"][0]["workloads"].append(cell)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    code = RUN_COPY % {"root": str(tiny_root), "repo": str(ROOT),
                       "cell": cell}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    counts, out = json.loads(lines[0]), json.loads(lines[-1])
    k2 = Registry(ROOT).counts("k2")
    assert counts["k2"] == k2.step_ops("eight_schools", 10) + 1
    assert counts["arwmh_step"] == counts["k2"] + 5 * 55
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"pe_gap", "frozen_share", "clock_gap",
                                  "accept_gap", "law_gap"}
    assert out["metrics"]["chain_iters_per_s"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
