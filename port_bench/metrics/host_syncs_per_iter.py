"""host_syncs_per_iter (syncs/iter): synchronising CUDA runtime calls
(stream, device and event synchronises, blocking copies) in the trace that
the program makes inside the stretch's ``engine.iteration`` spans, over
those iterations."""

from .. import program_spans


def read(ctx):
    its = program_spans.iterations(ctx)
    if its is None:
        return None
    return len(program_spans.syncs(ctx, its)) / len(its)
