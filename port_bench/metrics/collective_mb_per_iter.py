"""collective_mb_per_iter (MB/iter): the bytes rank 0 hands to the
collectives an iteration (counter ``parallel.bytes``, parallel/distributed.py:
the tensor it sums, its part of a gather, what it sends a hop, a broadcast's
on its source), inside the stretch's ``engine.iteration`` spans, over
those iterations, in 10^6 bytes.  None where they ran no collective."""

from .. import program_spans


def read(ctx):
    its = program_spans.iterations(ctx)
    if its is None or not any("parallel.bytes" in c for _, _, c in its):
        return None
    return sum(c.get("parallel.bytes", 0) for _, _, c in its) / len(its) / 1e6
