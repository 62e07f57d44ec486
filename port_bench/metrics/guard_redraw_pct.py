"""guard_redraw_pct (%): SNP draws whose first candidate the SBayesS guard
rejected, over the SNP draws made in the window (chains x iterations x m),
from the chain's own counter (extras["guard"])."""

import numpy as np


def read(ctx):
    guard = ctx["extras"].get("guard")
    if guard is None:
        return None
    rejected = float(np.asarray(guard).reshape(-1, 2)[:, 0].sum())
    draws = ctx["chains"] * ctx["niter"] * ctx["cfg"]["m"]
    return 100.0 * rejected / draws
