"""Posterior-analysis utilities from the reference notebooks (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/analysis/posterior.py``:

* :func:`pe_offset` — the potential-energy normalization constant
  pe_offset = −logsumexp(−PE(ref draws)) used to overlay PE traces across
  kernels (posteriordb_eight-schools.ipynb cell 24).
* :func:`functional_convergence` — running Monte-Carlo estimate of a
  functional φ(θ) vs draw count (posteriordb_eight-schools.ipynb cells
  59-60; e.g. φ = min_j θ_j).
* :func:`posterior_predictive` — y_rep draws given posterior samples
  (posteriordb_kidiq-kidscore.ipynb cells 77-79).

Everything runs on the device of the tensors it is given.  The predictive
noise comes from an explicit ``torch.Generator`` on that device: one
``torch.randn((n,) + observation shape)`` call, row k for draw k, so a
caller that replays the generator recovers it.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from adaptive_mcmc_tpu_torch.models import data as _data

Tensor = torch.Tensor


def pe_offset(potential_energies) -> Tensor:
    """−logsumexp(−PE) over a set of reference draws: shifts PE traces so
    the best achievable value is comparable across targets."""
    pe = torch.as_tensor(potential_energies)
    return -torch.logsumexp(-pe.reshape(-1), dim=0)


def functional_convergence(samples: Tensor,
                           fn: Callable[[Tensor], Tensor]) -> Tensor:
    """Running mean of φ(θ_i) over draws.  ``samples``: (n, d) in the order
    drawn, ``fn`` maps one draw (d,) to a scalar; returns (n,) running
    estimates (use with ``ns_logscale`` indices for log-grid plots)."""
    vals = torch.vmap(fn)(samples)
    count = torch.arange(1, vals.shape[0] + 1, device=vals.device,
                         dtype=vals.dtype)
    return torch.cumsum(vals, dim=0) / count


def _on(a, device) -> Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def posterior_predictive(target, generator: torch.Generator,
                         samples_unconstrained: Tensor) -> Mapping[str, Tensor]:
    """Draw y_rep for each posterior draw (n, dim), on the draws' device.
    Supported targets: kidiq, eight_schools_(non)centered, diamonds."""
    name = target.name
    x = samples_unconstrained
    dev = x.device
    sites = target.constrain(x)

    def noise(shape):
        return torch.randn((x.shape[0],) + tuple(shape), generator=generator,
                           device=dev)

    if name == "kidiq":
        d = _data.kidiq()
        hs = _on(d["mom_hs"], dev)
        X = torch.stack([torch.ones_like(hs), hs, _on(d["mom_iq"], dev)],
                        dim=1)
        mu = sites["beta"] @ X.T                           # (n, N)
        return {"kid_score_rep": mu + sites["sigma"][:, None]
                * noise(mu.shape[1:])}

    if name.startswith("eight_schools"):
        sigma_obs = _on(_data.eight_schools()["sigma"], dev)
        if "theta_base" in sites:
            theta = sites["mu"][:, None] + sites["tau"][:, None] \
                * sites["theta_base"]
        else:
            theta = sites["theta"]
        return {"y_rep": theta + sigma_obs * noise(theta.shape[1:])}

    if name == "diamonds":
        X = _on(_data.diamonds()["X"], dev)
        Xc = X[:, 1:] - torch.mean(X[:, 1:], dim=0, keepdim=True)
        mu = sites["Intercept"][:, None] + sites["b"] @ Xc.T
        return {"Y_rep": mu + sites["sigma"][:, None] * noise(mu.shape[1:])}

    raise ValueError(f"no predictive sampler for target {name!r}")
