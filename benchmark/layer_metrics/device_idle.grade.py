"""The card's idle share in the traced window of a grading cell: 1 − the
union of the device operations' intervals over the window."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
