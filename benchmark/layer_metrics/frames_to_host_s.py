"""Seconds an ``MCMC.run`` spends copying its frames to pinned host
memory: the program's ``run_mcmc.to_host`` spans inside ``MCMC.run`` over
the traced window's ``MCMC.run`` spans.  The span opens once the
collection has ended, so it times the copy, not the kernel.  A program
without that span (the CPU, whose frames are already on the host, or a
program that copies its draws elsewhere) reads None."""

from benchmark import program_spans as ps


def read(ctx):
    spans = ps.recorded()
    if spans is None:
        return None
    runs = ps.named(spans, "MCMC.run")
    if not runs or not ps.named(spans, "run_mcmc.to_host"):
        return None
    return ps.seconds(spans, "run_mcmc.to_host", within="MCMC.run") \
        / len(runs)
