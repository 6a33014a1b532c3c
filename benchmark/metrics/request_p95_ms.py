"""End to end (online): the 95th percentile of every request's latency in
the window, host clock from the call into ``decode_many`` to its return
(outputs are numpy arrays on the host)."""

WRAPS = []


def read(ctx):
    import statistics

    if len(ctx.latencies_ms) < 20:
        return None
    return statistics.quantiles(ctx.latencies_ms, n=20,
                                method="inclusive")[-1]
