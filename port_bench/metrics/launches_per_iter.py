"""launches_per_iter (launches/iter): device kernels an iteration, all of
them, counted in the profiler's trace."""


def read(ctx):
    n = sum(1 for cat, _, _, _ in ctx["timeline"]["device"] if cat == "kernel")
    return n / ctx["iters"] if n else None
