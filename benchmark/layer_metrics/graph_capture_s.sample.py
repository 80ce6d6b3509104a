"""Seconds an ``MCMC.run`` spends capturing CUDA graphs (the lockstep
step's block, captured anew per call): the program's ``graph.capture``
spans inside ``MCMC.run`` over the traced window's ``MCMC.run`` spans.  On
the card a window whose runs captured nothing (a graph kept from an
earlier call) reads 0; on the CPU, which captures nothing, None."""

from benchmark import program_spans as ps


def read(ctx):
    spans = ps.recorded()
    if spans is None:
        return None
    runs = ps.named(spans, "MCMC.run")
    captured = ps.seconds(spans, "graph.capture", within="MCMC.run")
    if not runs or (captured <= 0 and not ps.on_card(ctx)):
        return None
    return captured / len(runs)
