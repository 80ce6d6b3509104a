"""Seconds a ``run_w_eval`` job spends copying its draws to the host and
writing its compressed npz and manifest: the program's spans
``run_w_eval.to_host`` and ``run_w_eval.save`` over the traced window's
``run_w_eval`` spans."""

from benchmark import program_spans as ps


def read(ctx):
    spans = ps.recorded()
    if spans is None or not ps.named(spans, "run_w_eval"):
        return None
    jobs = len(ps.named(spans, "run_w_eval"))
    return (ps.seconds(spans, "run_w_eval.to_host")
            + ps.seconds(spans, "run_w_eval.save")) / jobs
