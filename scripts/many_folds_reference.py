"""Write the JAX package's reference for tests/test_torch_many_folds.py:
one ibrm iteration and one guarded tiled sbrm iteration of BayesR with 640
folds, in float64 on the CPU, from the states and random numbers that the
test makes again (tests/test_torch_many_folds.py:ibrm_case, sbrm_case).

The JAX package's XLA scans unroll a draw's folds: compiled at 640 folds
they take tens of GB and more than a quarter of an hour, so they run here
op by op (``jax.disable_jit``: minutes), once; their outputs are kept in
tests/data/many_folds_jax.npz, each case's with a digest of its inputs
(``{case}.inputs_sha256``) that the test checks.  Run from the repository
root:

    python scripts/many_folds_reference.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from tests import test_torch_many_folds as T  # noqa: E402


def main():
    out = {}
    for name, case in (("ibrm", T.ibrm_case), ("sbrm", T.sbrm_case)):
        c = case()
        with jax.disable_jit():
            ref = c["jax"]()
        for field, v in ref._asdict().items():
            leaves = v if isinstance(v, tuple) else (v,)
            for i, leaf in enumerate(leaves):
                out[f"{name}.{field}.{i}"] = np.asarray(leaf)
        out[f"{name}.inputs_sha256"] = np.asarray(T.inputs_digest(c))
        print(name, "done", flush=True)
    np.savez_compressed(T.REFERENCE, **out)
    print("wrote", T.REFERENCE)


if __name__ == "__main__":
    main()
