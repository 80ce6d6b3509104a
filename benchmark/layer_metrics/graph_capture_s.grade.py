"""Seconds of the ε-auction's CUDA-graph captures (a block of rounds per
block width, captured anew per solve) per set graded: the program's
``graph.capture`` spans inside ``auction.solve`` over the traced window's
sets.  On the card a window whose solves captured nothing (graphs kept
from an earlier solve) reads 0; on the CPU, which captures nothing,
None."""

from benchmark import program_spans as ps


def read(ctx):
    spans = ps.recorded()
    sets = ctx.traced_work.get("sets", 0)
    if spans is None or sets <= 0 or not ps.named(spans, "auction.solve"):
        return None
    captured = ps.seconds(spans, "graph.capture", within="auction.solve")
    if captured <= 0 and not ps.on_card(ctx):
        return None
    return captured / sets
