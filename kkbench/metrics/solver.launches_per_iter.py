"""Device operations (kernels, copies, fills) per iteration, counted in the
device trace of a stretch of whole solves."""


def read(ctx):
    t = ctx.trace
    if not t or "device_ops" not in t or not t["iters"]:
        return None
    return t["device_ops"] / t["iters"]
