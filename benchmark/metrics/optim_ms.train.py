"""Device time under the ``bench.optim`` span (``AdamChain.step``: the
accumulation, clip, Adam and the update) an optimizer step, in ms."""

def read(run):
    tl, steps = run.timeline, run.stats.get("units")
    if tl is None or not steps or not tl.span_count("bench.optim"):
        return None
    return 1e3 * tl.device_s("bench.optim") / steps
