"""rng_generators_per_iter (gens/iter): random generators the program built
and seeded an iteration (counter ``rng.generators``, engine/rng.py), inside
the stretch's ``engine.iteration`` spans, over those iterations."""

from .. import program_spans


def read(ctx):
    its = program_spans.iterations(ctx)
    if its is None:
        return None
    return sum(c.get("rng.generators", 0) for _, _, c in its) / len(its)
