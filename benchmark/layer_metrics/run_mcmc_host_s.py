"""Seconds an ``MCMC.run`` spends outside its warmup and its collection:
the program's ``MCMC.run`` spans less their ``run_mcmc.warmup`` and
``run_mcmc.collect`` children, over the traced window's ``MCMC.run``
spans (the kernel's rebuild at the run's warmup, the chains' initial
state, the driver's own work).  A program without those spans reads
None."""

from benchmark import program_spans as ps

PHASES = ("run_mcmc.warmup", "run_mcmc.collect")


def read(ctx):
    spans = ps.recorded()
    if spans is None:
        return None
    runs = ps.named(spans, "MCMC.run")
    if not runs or not any(ps.named(spans, p) for p in PHASES):
        return None
    inner = sum(ps.seconds(spans, p, within="MCMC.run") for p in PHASES)
    return (sum(s.seconds for s in runs) - inner) / len(runs)
