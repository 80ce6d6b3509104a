"""Rounds of the ε-auction per set graded: the program's counter
``auction.rounds`` (rounds run, every ε level and solve) over the traced
window's sets."""

from benchmark import program_spans as ps


def read(ctx):
    spans = ps.recorded()
    sets = ctx.traced_work.get("sets", 0)
    if spans is None or sets <= 0 or not ps.named(spans, "auction.solve"):
        return None
    return ps.counted(spans, "auction.rounds") / sets
