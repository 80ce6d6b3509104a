"""Graphical-model (plate-notation) diagrams for the benchmark targets
(the port's own copy of ``adaptive_mcmc_tpu/analysis/model_diagrams.py``).

The reference renders these with numpyro.render_model + graphviz
(`model-*.svg` in img/svg/: eight-schools centered & noncentered,
diamonds, kidiq).  This environment has no `dot` binary, so the same
diagrams are drawn directly with matplotlib: ellipse nodes (shaded =
observed, double border = deterministic), arrows for dependencies, and
rounded plate rectangles with the plate size in the corner.

Node inventories match the reference diagrams exactly (the <text> labels
of the reference's model-*.svg) and the model definitions in
models/targets.py.  matplotlib is imported where a diagram is drawn, so
the module imports where it is missing.

Run:  python -m adaptive_mcmc_tpu_torch.analysis.model_diagrams [img_dir]
(img_dir defaults to ``mcmc_runs/torch/img``)
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path

from adaptive_mcmc_tpu_torch.experiments.configs import OUT_ROOT

OUT_DIR = Path(OUT_ROOT) / "img"


@dataclass
class Node:
    name: str
    dist: str
    x: float
    y: float
    observed: bool = False
    deterministic: bool = False


@dataclass
class Plate:
    label: str
    x0: float
    y0: float
    x1: float
    y1: float


@dataclass
class Diagram:
    nodes: dict
    edges: list
    plates: list = field(default_factory=list)


NODE_W, NODE_H = 2.6, 1.15


def _render(diag: Diagram, path: Path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse, FancyArrowPatch, FancyBboxPatch

    xs = [n.x for n in diag.nodes.values()]
    ys = [n.y for n in diag.nodes.values()]
    fig, ax = plt.subplots(
        figsize=(
            (max(xs) - min(xs)) / 2.2 + 2.6,
            (max(ys) - min(ys)) / 2.2 + 1.8,
        )
    )
    for p in diag.plates:
        ax.add_patch(
            FancyBboxPatch(
                (p.x0, p.y0), p.x1 - p.x0, p.y1 - p.y0,
                boxstyle="round,pad=0.12,rounding_size=0.25",
                fill=False, edgecolor="0.35", linewidth=1.1,
            )
        )
        ax.text(p.x1 - 0.12, p.y0 + 0.1, p.label, ha="right", va="bottom",
                fontsize=11, color="0.25")
    for a, b in diag.edges:
        na, nb = diag.nodes[a], diag.nodes[b]
        ax.add_patch(
            FancyArrowPatch(
                (na.x, na.y), (nb.x, nb.y),
                arrowstyle="-|>", mutation_scale=14, color="0.2",
                shrinkA=24, shrinkB=24, linewidth=1.1, zorder=1,
            )
        )
    for n in diag.nodes.values():
        face = "0.85" if n.observed else "white"
        w = max(NODE_W, 0.22 * max(len(n.name), len(n.dist) + 2) + 0.7)
        ax.add_patch(
            Ellipse((n.x, n.y), w, NODE_H, facecolor=face,
                    edgecolor="black", linewidth=1.2, zorder=2)
        )
        if n.deterministic:
            ax.add_patch(
                Ellipse((n.x, n.y), w - 0.22, NODE_H - 0.12,
                        facecolor="none", edgecolor="black", linewidth=0.8,
                        zorder=2)
            )
        ax.text(n.x, n.y + 0.16, n.name, ha="center", va="center",
                fontsize=11, zorder=3)
        ax.text(n.x, n.y - 0.22, f"~ {n.dist}", ha="center", va="center",
                fontsize=8, color="0.3", zorder=3)
    ax.set_xlim(min(xs) - 1.8, max(xs) + 1.8)
    ax.set_ylim(min(ys) - 1.3, max(ys) + 1.1)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def eight_schools_centered() -> Diagram:
    nodes = {
        "mu": Node("mu", "Normal", 0.0, 2.6),
        "tau": Node("tau", "HalfCauchy", 3.4, 2.6),
        "theta": Node("theta", "Normal", 1.7, 0.9),
        "obs": Node("obs", "Normal", 1.7, -0.9, observed=True),
    }
    edges = [("mu", "theta"), ("tau", "theta"), ("theta", "obs")]
    plates = [Plate("J", 0.0, -1.75, 3.4, 1.75)]
    return Diagram(nodes, edges, plates)


def eight_schools_noncentered() -> Diagram:
    nodes = {
        "mu": Node("mu", "Normal", 0.0, 2.6),
        "tau": Node("tau", "HalfCauchy", 3.4, 2.6),
        "theta_decentered": Node(
            "theta_decentered", "Normal", 6.3, 0.9
        ),
        "theta": Node("theta", "Deterministic", 1.7, 0.9,
                      deterministic=True),
        "obs": Node("obs", "Normal", 1.7, -0.9, observed=True),
    }
    edges = [
        ("mu", "theta"), ("tau", "theta"),
        ("theta_decentered", "theta"), ("theta", "obs"),
    ]
    plates = [Plate("J", 0.0, -1.75, 8.3, 1.75)]
    return Diagram(nodes, edges, plates)


def diamonds() -> Diagram:
    nodes = {
        "Intercept": Node("Intercept", "StudentT", 0.0, 2.6),
        "b": Node("b", "Normal", 3.4, 2.6),
        "sigma": Node("sigma", "FoldedDistribution", 6.4, 2.6),
        "mu": Node("mu", "Deterministic", 1.7, 0.9, deterministic=True),
        "Y": Node("Y", "Normal", 3.9, -0.9, observed=True),
    }
    edges = [
        ("Intercept", "mu"), ("b", "mu"), ("mu", "Y"), ("sigma", "Y"),
    ]
    plates = [Plate("N", 0.2, -1.75, 5.6, 1.75)]
    return Diagram(nodes, edges, plates)


def kidiq() -> Diagram:
    nodes = {
        "beta": Node("beta", "ImproperUniform", 0.0, 2.6),
        "sigma": Node("sigma", "HalfCauchy", 4.4, 2.6),
        "mu": Node("mu", "Deterministic", 0.8, 0.9, deterministic=True),
        "kid_score_obs": Node("kid_score_obs", "Normal", 2.4, -0.9,
                              observed=True),
    }
    edges = [("beta", "mu"), ("mu", "kid_score_obs"),
             ("sigma", "kid_score_obs")]
    plates = [Plate("N", -0.8, -1.75, 4.2, 1.75)]
    return Diagram(nodes, edges, plates)


ALL = {
    # file names match the reference img/svg inventory
    "model-eight-schools-centered": eight_schools_centered,
    "model_eight_schools": eight_schools_noncentered,
    "model-diamonds": diamonds,
    "model-kidiq-kidscore": kidiq,
}


def main(out_dir=OUT_DIR):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, build in ALL.items():
        _render(build(), out / f"{name}.svg")
        print(f"[fig] {name}.svg")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else OUT_DIR)
