"""sweep1_lookahead_pct (%): the one-chain sweep's blocks whose right-hand
side sweep1_kernel formed one block ahead (counter ``ops.sweep1.lookahead``,
ops/blockgibbs.py:sweep_mc) over the blocks it launched (``ops.sweep1.blocks``),
inside the stretch's ``engine.iteration`` spans; None where the program
counts no such block."""

from .. import program_spans


def read(ctx):
    its = program_spans.iterations(ctx)
    if its is None:
        return None
    blocks = sum(c.get("ops.sweep1.blocks", 0) for _, _, c in its)
    if not blocks:
        return None
    return 100.0 * sum(c.get("ops.sweep1.lookahead", 0) for _, _, c in its) / blocks
