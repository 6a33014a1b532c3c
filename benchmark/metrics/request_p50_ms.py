"""facade / routing: the median request latency (host clock, from the
call into ``decode_many`` to its return), beside the p95."""

WRAPS = []


def read(ctx):
    import statistics

    if not ctx.latencies_ms:
        return None
    return statistics.median(ctx.latencies_ms)
