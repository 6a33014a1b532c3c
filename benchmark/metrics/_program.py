"""What the per-layer readers of the port's own spans share: the traced
window's requests from ``symphonia_tpu_torch.trace``, the last
``ctx.requests`` ``decode_many`` requests of its store (a process that runs
several windows reads each alone), or None where the store holds none of
them (an untraced run, or a port without ``trace``)."""


def window(ctx):
    try:
        from symphonia_tpu_torch import trace
    except ImportError:
        return None
    if not ctx.requests:
        return None
    reqs = trace.requests(last=ctx.requests)
    if len(reqs) < ctx.requests or any(r.root.name != "decode_many"
                                       for r in reqs):
        return None
    return reqs


def share(ctx, names):
    """Percent of the window in the self time of the spans ``names``."""
    reqs = window(ctx)
    if reqs is None or ctx.window_s <= 0:
        return None
    ns = sum(r.self_ns.get(n, 0) for r in reqs for n in names)
    return 100.0 * ns * 1e-9 / ctx.window_s


def per_audio_s(ctx, counter):
    """Counter ``counter`` summed over the window, per second of audio
    decoded."""
    reqs = window(ctx)
    if reqs is None or ctx.audio_s <= 0:
        return None
    return sum(r.counters.get(counter, 0) for r in reqs) / ctx.audio_s
