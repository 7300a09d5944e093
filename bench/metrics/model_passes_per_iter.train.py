"""Model step: (shard, step) passes per iteration (``model.forward`` spans
over the window's iterations); the merging controller sets it."""


def read(win):
    n = len(win.span_ns("model.forward"))
    iters = win.counters.get("iterations", 0)
    if not n or not iters:
        return None
    return n / iters
