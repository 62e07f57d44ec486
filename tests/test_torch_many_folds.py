"""BayesR with 640 folds, where one SNP's packed rows overflow the tiled
sweep's shared memory even at sub-blocks of 4 SNPs (guarded: 3 + 4 x 639
packed rows and 1 + 8 x 639 guard rows, 30 KB a SNP): its draws read the
rows from global memory (``SubBlocks.rows_global``, the run-time fold
instance of csrc/draws.cuh through L2), at the store's own tiles.  The
plain versions take the same route, so these f64 tests hold it to the JAX
package: one guarded tiled sbrm iteration and one ibrm iteration from the
same state with JAX's numbers, every state field to rtol 1e-9.

The JAX package's XLA scans unroll a draw's folds: compiled at 640 folds
they take tens of GB and more than a quarter of an hour, and run op by op
(``jax.disable_jit``) minutes.  So JAX's outputs
for these two cases are kept in tests/data/many_folds_jax.npz, written by
scripts/many_folds_reference.py (op by op) from the same cases; the test
makes the inputs and JAX's random numbers again and runs the port.  The file
keeps a digest of the inputs it was made from (:func:`inputs_digest`), so a
change to the cases' setup fails with the script to rerun.  The card holds
each against its plain version (tests/test_torch_cuda.py)."""

import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import (chain_state_from_numpy, gibbs_data_from_numpy,
                                              s_chain_state_from_numpy, sgibbs_data_from_numpy)
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_sgibbs_guard import JaxRedrawNoise
from .torch_parity import JaxNoise, model_setup, port_spec, s_setup, with_sparse_effects

torch.set_num_threads(2)

NF = 640
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "many_folds_jax.npz")


@functools.cache
def ibrm_case():
    """One ibrm chain (n=100, m=24 in blocks of 8) at a mid-run state."""
    s = model_setup("BayesR", n=100, m=24, B=8, dtype=jnp.float64, warm=0, nf=NF)
    state = with_sparse_effects(s)["state"]
    key = jax.random.PRNGKey(5)
    return dict(
        spec=port_spec(s["spec"]), data=gibbs_data_from_numpy(s["data"]),
        state=chain_state_from_numpy(state), noise=lambda: JaxNoise(key, int(state.it)),
        fields=TG.ChainState._fields, inputs=(s["spec"], s["data"], state, key),
        jax=lambda: G.one_iteration(s["spec"], s["data"], key, state))


@functools.cache
def sbrm_case():
    """One guarded chain on a tile-16 TiledSparseLD (m=64, 4 tile rows) at
    a mid-run state: sparse effects g and r_hat = xy - n LD g."""
    s = s_setup("BayesR", "tiled16", m=64, nf=NF)
    spec, data = s["spec"], s["data"]
    state = SG.init_s_state(spec, data, s["pr"], s["pi"])
    rng = np.random.default_rng(3)
    real = np.asarray(data.real)
    g = np.where(real & (rng.random(spec.m_pad) < 0.2), rng.normal(0, 0.02, spec.m_pad), 0.0)
    ldg = np.pad(s["ld_t"].to_dense() @ g[:spec.m], (0, spec.m_pad - spec.m))
    state = state._replace(g=jnp.asarray(g), r_hat=jnp.asarray(
        np.asarray(data.xy) - spec.n * ldg), it=jnp.asarray(3, state.it.dtype))
    key = jax.random.PRNGKey(5)
    return dict(
        spec=port_spec(spec), data=sgibbs_data_from_numpy(data),
        state=s_chain_state_from_numpy(state), noise=lambda: JaxRedrawNoise(key, 3),
        fields=TSG.SChainState._fields, inputs=(spec, data, state, key),
        jax=lambda: SG.one_s_iteration(spec, data, key, state))


def inputs_digest(case):
    """sha256 of a case's JAX inputs: its spec, data, state and the key of
    its random numbers (which, with the state's iteration, fix them)."""
    spec, *trees = case["inputs"]
    h = hashlib.sha256(repr(spec).encode())
    for leaf in jax.tree_util.tree_leaves(trees):
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _assert_reference(name, out, case):
    ref = np.load(REFERENCE)
    assert str(ref[f"{name}.inputs_sha256"]) == inputs_digest(case), (
        f"{REFERENCE} was made from other inputs than the {name} case makes now: "
        "rerun scripts/many_folds_reference.py")
    fields = case["fields"]
    for field in fields[1:]:
        o = getattr(out, field)
        for i, leaf in enumerate(o if isinstance(o, tuple) else (o,)):
            a, b = ref[f"{name}.{field}.{i}"], leaf.numpy()
            assert a.shape == b.shape, field
            if field == "track":
                np.testing.assert_array_equal(b, a, err_msg=field)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=1e-9, atol=1e-9 * np.abs(a).max(initial=0), err_msg=field)


def test_kernel_width_reads_rows_from_global_memory():
    """At 640 guarded folds the tiled sweep keeps tiles of 64 and 128 and
    reads the packed rows from global memory; at 4 folds it stages them in
    shared memory; no fold count raises."""
    spec = sbrm_case()["spec"]
    assert TB.summary_rows(spec) == 3 + 4 * (NF - 1) + 1 + 8 * (NF - 1)
    for B in (64, 128):
        sb = TB.tiled_sub_blocks(spec, B)
        assert sb.same and sb.rows_global
    few = spec.__class__(**{**spec.__dict__, "n_fold": 4})
    assert not TB.tiled_sub_blocks(few, 128).rows_global
    assert TB.tiled_sub_blocks(spec.__class__(**{**spec.__dict__, "n_fold": 5000}), 128)


def test_guarded_tiled_sbrm_640_folds_matches_jax():
    """One guarded sbrm iteration with 640 folds on the tile-16 LD, the
    guard's candidates JAX's own first 8 redraws: every SChainState field
    equals JAX's guarded XLA scan to rtol 1e-9, no draw exhausting its
    candidates."""
    c = sbrm_case()
    tally = torch.zeros(2, dtype=torch.int64)
    out = TSG.one_s_iteration(c["spec"], c["data"], 0, c["state"], noise=c["noise"](),
                              tally=tally)
    assert int(tally[1]) == 0
    _assert_reference("sbrm", out, c)


def test_ibrm_640_folds_matches_jax():
    """One ibrm iteration (a mid-run state, n=100, m=24 in blocks of 8)
    with 640 folds: every ChainState field equals JAX's to rtol 1e-9."""
    c = ibrm_case()
    out = TG.one_iteration(c["spec"], c["data"], 0, c["state"], noise=c["noise"]())
    _assert_reference("ibrm", out, c)
