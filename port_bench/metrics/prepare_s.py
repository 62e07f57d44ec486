"""prepare_s (s): the model layer's preparation, the harness's span around
prepare_gibbs_data / prepare_sgibbs_data, resolve_priors and the spec,
ending in a synchronise."""


def read(ctx):
    return ctx["spans"].get("prepare_s")
