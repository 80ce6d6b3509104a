"""K3's iterations (potential evaluations) per transition in the traced
window: the program's counters ``k3.iters`` (the chains' iterations,
summed on the card per launch) over ``k3.steps`` (transitions: steps times
chains)."""

from benchmark import program_spans as ps


def read(ctx):
    spans = ps.recorded()
    if spans is None:
        return None
    steps = ps.counted(spans, "k3.steps")
    if steps <= 0:
        return None
    return ps.counted(spans, "k3.iters") / steps
