"""The value pass's share of its roofline: each chunk's least time
(`gossipbench.work.gossip.pair_apply_chunk`: the state read and
written, the pairs and bits read, over HBM) over the device time of
the `pair_apply` kernel in the traced calls."""

KERNELS = ("pair_apply_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    dev = ctx.trace.device_time_s(lambda n: any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    bound = sum(ctx.least_s(b, flops, "f32")
                for w in ctx.work for b, flops in w["pair_apply"])
    return 100.0 * bound / dev
