"""Entries: ``entries/<entry>.py`` holds the ``Fit`` of the configurations
whose ``entry`` names it."""

from __future__ import annotations

import numpy as np

from hibayes_tpu_torch.model.ibrm import resolve_iteration_defaults


def mixture(cfg: dict, thin: int) -> tuple:
    """(Pi, fold) of the configuration, passed through the model layer's
    checks as a user's would be; they must be the reference defaults that
    the configuration states it runs (fold None for a one-slab method)."""
    method = cfg["method"]
    _, _, Pi, fold = resolve_iteration_defaults(method, None, None, thin, cfg["Pi"],
                                                cfg.get("fold"))
    _, _, Pi0, fold0 = resolve_iteration_defaults(method, None, None, thin, None, None)
    if not np.array_equal(Pi, Pi0) or (fold is None) != (fold0 is None) or (
            fold is not None and not np.array_equal(fold, fold0)):
        raise ValueError(f"the configuration's Pi {cfg['Pi']} and fold {cfg.get('fold')} "
                         f"are not the reference defaults of {method}")
    return Pi, fold
