"""The whole call's share of the card's peak: the least time of the
traced calls' work, the larger of all their bytes (draw, value pass,
attribution) over HBM, their hash operations over the int32 rate and
their float operations over the f32 rate, over the traced calls' wall
time.  It reads the same work whatever kernels carry it."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.trace.window_s <= 0:
        return None
    nbytes = int_ops = f32_ops = 0
    for w in ctx.work:
        nbytes += sum(b for b, _ in w["draw"]) + w["attribution"]
        int_ops += sum(ops for _, ops in w["draw"])
        nbytes += sum(b for b, _ in w["pair_apply"])
        f32_ops += sum(f for _, f in w["pair_apply"])
    p = ctx.peaks
    least = max(nbytes / p["bytes_per_s"], int_ops / p["int32_per_s"],
                f32_ops / p["f32_per_s"])
    return 100.0 * least / ctx.trace.window_s
