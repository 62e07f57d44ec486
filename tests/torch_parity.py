"""Shared set-up of the parity tests between hibayes_tpu (JAX, the reference)
and hibayes_tpu_torch (the PyTorch port).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; the port receives JAX's own random numbers through
:class:`JaxNoise`, a drop-in for the port's per-iteration noise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.rng import IterNoise

MODELS = ["BayesRR", "BayesA", "BayesBpi", "BayesCpi", "BayesL", "BayesR"]
CONST_KEYS = ("varg", "s2varg_df", "logpi", "lambda2", "vara_fold", "fold")


class JaxNoise(IterNoise):
    """The JAX engine's draws for iteration ``it``: fold_in(fold_in(base_key,
    it), stream) with the same shapes and parameters the JAX engine uses."""

    def __init__(self, base_key, it, dtype=jnp.float64):
        super().__init__(0, it, "cpu", torch.float64 if dtype == jnp.float64
                         else torch.float32)
        self.key = jax.random.fold_in(base_key, it)
        self.jdt = dtype

    def _k(self, stream):
        return jax.random.fold_in(self.key, stream)

    def _out(self, x):
        return torch.from_numpy(np.array(x))

    def normal(self, stream, shape=()):
        return self._out(jax.random.normal(self._k(stream), tuple(shape), dtype=self.jdt))

    def uniform(self, stream, shape=()):
        return self._out(jax.random.uniform(self._k(stream), tuple(shape), dtype=self.jdt))

    def gamma(self, stream, alpha, shape=None):
        a = jnp.asarray(np.asarray(alpha), self.jdt)
        return self._out(jax.random.gamma(self._k(stream), a,
                                          None if shape is None else tuple(shape),
                                          dtype=self.jdt))


def tt(x):
    """A JAX/numpy array as a CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def model_setup(model, *, n, m, B, dtype=jnp.float32, int8=True, seed=4,
                nc=0, nfactor=0, windows=False, warm=1):
    """JAX data, priors, spec and a state after ``warm`` plain JAX iterations
    for one model on synthetic genotypes (one SNP monomorphic)."""
    rng = np.random.default_rng(seed)
    M = rng.binomial(2, rng.uniform(0.1, 0.5, m), size=(n, m)).astype(np.int8)
    M[:, 3] = 1  # monomorphic
    y = M.astype(np.float64) @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    if model == "BayesR":
        nf, pi = 4, np.array([0.95, 0.02, 0.02, 0.01])
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        nf, fold = 2, None
        pi = (np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
              else np.array([0.95, 0.05]))
    C = rng.normal(size=(n, nc)) if nc else None
    codes = tuple(rng.integers(0, 5, n) for _ in range(nfactor))
    nlev = tuple(5 for _ in range(nfactor))
    nw, windindx = 0, None
    if windows:
        windindx = np.repeat(np.arange(1, m // 8 + 2), 8)[:m]
        nw = int(windindx.max())
    data = G.prepare_gibbs_data(
        y, M if int8 else M.astype(np.float32), C=C, r_codes=codes,
        r_nlevels=nlev, fold=fold, windindx=windindx, nw=nw, block=B,
        dtype=dtype, geno_dtype="int8" if int8 else None)
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=nfactor)
    spec = G.GibbsSpec(
        model=model, n=int(data.y.shape[0]), n_real=n, m=m,
        m_pad=int(data.xpx.shape[0]), block=int(data.X_blocks.shape[2]),
        nc=nc, nlevels=nlev, n_fold=nf, niter=40, nburn=2, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()), nw=nw,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        resync_every=0, fixpi=model in ("BayesB", "BayesC"))
    state = G.init_state(spec, data, pr, pi)
    base = jax.random.PRNGKey(seed)
    for _ in range(warm):
        state = G.one_iteration(spec, data, base, state)
    return dict(M=M, y=y, C=C, codes=codes, nlev=nlev, fold=fold, pi=pi,
                windindx=windindx, nw=nw, data=data, pr=pr, spec=spec,
                state=state)


def with_sparse_effects(setup, seed=5, frac=0.3, scale=0.05):
    """The setup with a chain state as one mid-run would hold, without running
    the JAX engine: a sparse random effect vector g on the real SNPs and the
    residual yadj corrected for it."""
    spec, data, st = setup["spec"], setup["data"], setup["state"]
    rng = np.random.default_rng(seed)
    nz = (rng.random(spec.m_pad) < frac) & np.asarray(data.real)
    g = np.where(nz, rng.normal(0, scale, spec.m_pad), 0.0)
    Xb = np.asarray(data.X_blocks, dtype=np.float64)
    X = Xb.transpose(1, 0, 2).reshape(Xb.shape[1], -1)
    dt = st.yadj.dtype
    state = st._replace(g=jnp.asarray(g, dt),
                        yadj=jnp.asarray(np.asarray(st.yadj, np.float64) - X @ g, dt))
    return {**setup, "state": state}


def port_spec(spec):
    from dataclasses import asdict

    return TG.GibbsSpec(**asdict(spec))


def sweep_inputs(setup, K, key=11):
    """Batched sweep inputs for K chains from JAX's own engine: each chain
    draws its own pre-sweep from the setup's state.  Returns the JAX argument
    tuple of ``sweep_mc_t`` (after spec) and the port's."""
    spec, data, st = setup["spec"], setup["data"], setup["state"]
    base = jax.random.PRNGKey(key)
    pres = [G._pre_sweep(spec, data, jax.random.fold_in(base, 1000 + k), st)
            for k in range(K)]
    gs = [st.g] * K
    stack = lambda xs: jnp.stack([jnp.asarray(x) for x in xs])
    consts_j = {c: stack([p["consts"][c] for p in pres]) for c in pres[0]["consts"]}
    per_chain = [stack([p["vei"] for p in pres]), stack(gs)]
    per_chain += [stack([p["rnd"][i] for p in pres]) for i in range(4)]
    per_chain += [stack([p["vargL_in"] for p in pres]),
                  stack([p["yadj"] for p in pres]), stack([p["u"] for p in pres])]
    jax_args = (consts_j, data.X_blocks, data.W_blocks, data.xpx, data.vx, *per_chain)
    consts_t = {c: tt(consts_j[c]) for c in CONST_KEYS}
    torch_args = (consts_t, tt(data.X_blocks), tt(data.W_blocks), tt(data.xpx),
                  tt(data.vx), *(tt(a) for a in per_chain))
    return jax_args, torch_args


SWEEP_NAMES = ["g", "track", "vargL", "yadj", "u", "vargi", "vargR"]


def assert_kernel_bar(ref, out, names=SWEEP_NAMES):
    """The bar of tests/test_pallas_kernel.py:64-76 between two f32 sweeps:
    at most 1% of the mixture draws flip, effects agree to 5e-5 max|g| where
    the draws agree, residuals to 1e-4 max|yadj| when none flips."""
    r = dict(zip(names, (np.asarray(x) for x in ref)))
    o = dict(zip(names, (np.asarray(x) for x in out)))
    agree = r["track"] == o["track"]
    assert agree.mean() >= 0.99, f"track flips {100 * (1 - agree.mean()):.2f}%"
    scale = np.abs(r["g"]).max() + 1e-12
    np.testing.assert_allclose(o["g"][agree], r["g"][agree], rtol=0, atol=5e-5 * scale)
    if agree.all() and "yadj" in r:
        np.testing.assert_allclose(
            o["yadj"], r["yadj"], rtol=0,
            atol=1e-4 * np.abs(r["yadj"]).max() + 1e-6)


def stack_states(states):
    """JAX states (or any pytrees) stacked on a leading chain axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def assert_state_fields(ref, out, fields, spread=None):
    """Every field to rtol 1e-9 (atol 1e-9 of the field's scale); where
    ``spread`` names a field, each entry may also differ by as much as the
    reference differs from itself there."""
    for name in fields:
        r, o = getattr(ref, name), getattr(out, name)
        for a, b in (zip(r, o) if isinstance(o, tuple) else [(r, o)]):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape, name
            if name == "track":
                np.testing.assert_array_equal(b, a)
                continue
            tol = 1e-9 * (np.abs(a).max() if a.size else 0) + 1e-9 * np.abs(a)
            if spread is not None and name in spread:
                tol = tol + spread[name]
            bad = ~(np.abs(b - a) <= tol)
            assert not bad.any(), (name, np.argwhere(bad)[:5], a[bad][:5], b[bad][:5])


# ---------------------------------------------------------------------------
# summary level (sbrm)
# ---------------------------------------------------------------------------


def s_sumstats(m, *, seed=21, n_panel=400, N=100_000, frac=0.05, scale=0.1,
               copy_p=0.55, pruned=False):
    """An LD panel with local LD and summary statistics consistent with it.

    Genotypes of n_panel individuals where each SNP copies its left
    neighbour with probability ``copy_p`` (adjacent r ~ copy_p, decaying
    with distance); R their covariance.  Marginal effects of a GWAS of N
    individuals: beta = (L b + R^(1/2) e / sqrt(N)) / diag(R), e ~ N(0, I),
    b sparse (``frac`` nonzero, N(0, scale^2)), L the LD the sampler will
    see: R, or with ``pruned`` the chi-square-pruned R (r^2 n_panel > 30,
    as ldmat prunes).  Returns (ss (m, 4), R, the pruned R, b)."""
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, 0.4, size=(n_panel, m)).astype(np.float64)
    for j in range(1, m):
        c = rng.random(n_panel) < copy_p
        X[c, j] = X[c, j - 1]
    Xc = X - X.mean(0)
    R = Xc.T @ Xc / n_panel
    d = np.sqrt(np.diag(R))
    r = R / np.outer(d, d)
    Rp = np.where((r * r * n_panel > 30.0) | np.eye(m, dtype=bool), R, 0.0)
    b = np.where(rng.random(m) < frac, rng.normal(0, scale, m), 0.0)
    L = np.linalg.cholesky(R + 1e-9 * np.eye(m))
    beta = ((Rp if pruned else R) @ b + L @ rng.normal(size=m) / np.sqrt(N)) / np.diag(R)
    se = np.sqrt(1.0 / (N * np.diag(R)))
    maf = np.full(m, 0.4)
    return np.column_stack([maf, beta, se, np.full(m, float(N))]), R, Rp, b


def s_pi_fold(model):
    if model == "BayesR":
        return np.array([0.95, 0.02, 0.02, 0.01]), np.array([0.0, 1e-4, 1e-3, 1e-2])
    if model in ("BayesRR", "BayesA", "BayesL"):
        return np.array([0.0, 1.0]), None
    return np.array([0.95, 0.05]), None


def s_setup(model, layout, *, m, dtype=jnp.float64, block=64, seed=21, windows=True,
            **kw):
    """JAX summary data, priors and spec for one model on ``layout`` "dense"
    (DenseLD, SBayesD semantics) or "tiled" (TiledSparseLD.from_scipy of the
    pruned LD, tile 128, SBayesS semantics with the guard), and the port's
    LD object of the same matrix."""
    import scipy.sparse as sp

    from hibayes_tpu.data.ld import DenseLD
    from hibayes_tpu.data.sparse_ld import TiledSparseLD
    from hibayes_tpu.engine import sgibbs as SG
    from hibayes_tpu_torch.data import ld as TLD
    from hibayes_tpu_torch.data import sparse_ld as TSLD

    ss, R, Rp, b = s_sumstats(m, seed=seed, pruned=layout == "tiled", **kw)
    if layout == "dense":
        ld_j, ld_t = DenseLD(values=R), TLD.DenseLD(values=R)
    else:
        block = 128
        ld_j = TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=block)
        ld_t = TSLD.TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=block)
    pi, fold = s_pi_fold(model)
    nw, windindx = 0, None
    if windows:
        windindx = np.repeat(np.arange(1, m // 50 + 2), 50)[:m]
        nw = int(windindx.max())
    data, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
        ss, ld_j, fold=fold, windindx=windindx, nw=nw, block=block, dtype=dtype)
    pr = G.resolve_priors(None, float(np.asarray(ld_j.diag).sum()), pi[0], nr=0,
                          vary=vary)
    spec = G.GibbsSpec(
        model=model, n=n_eff, m=m, m_pad=int(sum(seg_sizes)), block=block,
        nc=0, nlevels=(), n_fold=len(pi), niter=40, nburn=1, thin=5,
        nvar0=nvar0, nw=nw, fixpi=False,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True,
        real_excl_nvar0=True, reject_guard=layout == "tiled", vary=vary,
        seg_sizes=seg_sizes, seg_real=seg_real)
    return dict(ss=ss, ld_j=ld_j, ld_t=ld_t, pi=pi, fold=fold,
                windindx=windindx, nw=nw, block=block, data=data, pr=pr,
                spec=spec)
