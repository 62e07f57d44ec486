"""The port's single-step path (pedigree, imputation, epsilon Gibbs, ssbrm)
against the JAX reference on the CPU.  Inputs are made with numpy from a
seed and handed to both packages; each tolerance is stated where it is
used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hibayes_tpu_torch as htt
from hibayes_tpu.data import pedigree as JP
from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.math import solvers as JS
from hibayes_tpu.model.ssbrm import ssbrm as jax_ssbrm
from hibayes_tpu.ops.blockgibbs import mme_block_draws
from hibayes_tpu_torch.data import pedigree as TP
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.convert import (chain_state_from_numpy,
                                              epsl_sparse_from_numpy,
                                              gibbs_data_from_numpy)
from hibayes_tpu_torch.math import solvers as TS
from hibayes_tpu_torch.ops import blockgibbs as TB
from hibayes_tpu_torch.parallel.mesh import make_mesh

from .torch_parity import MODELS, JaxNoise, port_spec

torch.set_num_threads(2)


def _random_pedigree(nfound, nkid, seed=0):
    """Founders, then offspring whose parents are drawn among earlier ids
    (tests/test_ssbrm.py's generator)."""
    rng = np.random.default_rng(seed)
    ids = [f"F{i}" for i in range(nfound)]
    sires = ["0"] * nfound
    dams = ["0"] * nfound
    for k in range(nkid):
        ids.append(f"K{k}")
        sires.append(ids[rng.integers(0, len(ids) - 1)])
        dams.append(ids[rng.integers(0, len(ids) - 1)])
    return np.array(ids), np.array(sires), np.array(dams)


def _partition(nfound=60, nkid=400, n_g=120, seed=1):
    """A pedigree's A-inverse split into the non-genotyped (nn, RCM order)
    and non-genotyped x genotyped (ng) blocks."""
    rng = np.random.default_rng(seed)
    ids, sires, dams = _random_pedigree(nfound, nkid, seed=seed)
    _, s_idx, d_idx = TP.make_ped(ids, sires, dams)
    Ai = TP.make_ainv(s_idx, d_idx).tocsr()
    n = Ai.shape[0]
    g = np.sort(rng.choice(n, n_g, replace=False))
    ng = np.setdiff1d(np.arange(n), g)
    nn = Ai[ng].tocsc()[:, ng]
    ng = ng[TP.rcm_permutation(nn)]
    return Ai[ng].tocsc()[:, ng], Ai[ng].tocsc()[:, g]


# ---------------------------------------------------------------------------
# pedigree host functions: copies, bitwise
# ---------------------------------------------------------------------------


def test_pedigree_host_functions_equal_jax():
    """make_ped (with an unlisted parent and NA tokens), make_ainv in both
    compat settings, rcm_permutation and solve_a_ng give JAX's arrays bit
    for bit."""
    ids, sires, dams = _random_pedigree(30, 200, seed=3)
    sires[40], dams[41] = "ghost", "NA"
    for a, b in zip(TP.make_ped(ids, sires, dams), JP.make_ped(ids, sires, dams)):
        np.testing.assert_array_equal(a, b)
    _, s_idx, d_idx = TP.make_ped(ids, sires, dams)
    for compat in (False, True):
        a = TP.make_ainv(s_idx, d_idx, compat_hibayes=compat)
        b = JP.make_ainv(s_idx, d_idx, compat_hibayes=compat)
        assert (a != b).nnz == 0 and a.format == b.format == "csc"
        np.testing.assert_array_equal(a.toarray(), b.toarray())
    A = TP.make_ainv(s_idx, d_idx)
    np.testing.assert_array_equal(TP.rcm_permutation(A), JP.rcm_permutation(A))
    nn, ng = _partition()
    np.testing.assert_array_equal(TP.solve_a_ng(nn, ng), JP.solve_a_ng(nn, ng))


# ---------------------------------------------------------------------------
# imputation: batched PCG in float64
# ---------------------------------------------------------------------------


def test_imputation_operator_matches_jax_and_dense_solve():
    """The port's operator (float64 PCG, tol 1e-8 of each column's norm)
    against JAX's ImputationOperator and the dense solve: apply on 7
    columns and on one vector, impute on chosen rows in column chunks, to
    1e-6 (the bar of tests/test_ssbrm.py:247-268)."""
    rng = np.random.default_rng(3)
    nn, ng = _partition()
    A_dense = JP.solve_a_ng(nn, ng)
    op_t, op_j = TP.ImputationOperator(nn, ng), JP.ImputationOperator(nn, ng)
    V = rng.normal(size=(ng.shape[1], 7))
    out = op_t.apply(V).numpy()
    np.testing.assert_allclose(out, A_dense @ V, atol=1e-6)
    np.testing.assert_allclose(out, op_j.apply(V), atol=1e-6)
    np.testing.assert_allclose(op_t.apply(V[:, 0]).numpy(), A_dense @ V[:, 0], atol=1e-6)
    M = rng.binomial(2, 0.3, (ng.shape[1], 50)).astype(np.int8)
    rows = np.sort(rng.choice(nn.shape[0], 40, replace=False))
    imp = op_t.impute(M, rows_needed=rows, chunk_cols=16).numpy()
    np.testing.assert_allclose(imp, (A_dense @ M)[rows], atol=1e-6)
    np.testing.assert_allclose(imp, op_j.impute(M.astype(np.float64), rows_needed=rows,
                                                chunk_cols=16), atol=1e-6)


def test_pcg_solvers_match_jax():
    """pcg_batched on the pedigree system against JAX's (f64) to 1e-6 and
    the same iteration count, and against the right-hand side."""
    rng = np.random.default_rng(4)
    nn, _ = _partition()
    nn = sp.csr_matrix(nn)
    B = rng.normal(size=(nn.shape[0], 5))
    rows, cols, vals, lengths = TP.coo_device(nn)
    Xt, it_t = TS.pcg_batched(lambda X: TS.segment_matmul(lengths, cols, vals, X),
                              torch.as_tensor(B), diag=torch.as_tensor(nn.diagonal()))
    Nd = jnp.asarray(nn.toarray())
    Xj, it_j = JS.pcg_batched(lambda X: Nd @ X, jnp.asarray(B),
                              diag=jnp.asarray(nn.diagonal()))
    assert it_t == int(it_j)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-6)
    np.testing.assert_allclose(nn @ Xt.numpy(), B, atol=1e-6)


# ---------------------------------------------------------------------------
# the epsilon layout and sweep
# ---------------------------------------------------------------------------


def _triplets(sp_t):
    """(block, row, col, val) of the port's grouped triplets, row-sorted."""
    blk_ptr, row_ptr = sp_t.blk_ptr.numpy(), sp_t.row_ptr.numpy()
    out = []
    for i in range(len(blk_ptr) - 1):
        for u in range(blk_ptr[i], blk_ptr[i + 1]):
            for e in range(row_ptr[u], row_ptr[u + 1]):
                out.append((i, int(sp_t.urow[u]), int(sp_t.ent_col[e]), float(sp_t.ent_val[e])))
    return out


def test_build_epsl_sparse_equals_jax():
    """Diagonal blocks bitwise; the forward triplets of each block (JAX's
    without their zero padding) and the whole A as the same sets of
    (row, col, value), bitwise; converting JAX's layout gives the port's."""
    nn, _ = _partition(40, 300)
    T = 16
    sp_t, qp_t = TG._build_epsl_sparse(nn, T, torch.float64)
    sp_j, qp_j = G._build_epsl_sparse(nn, T, jnp.float64)
    assert qp_t == qp_j and qp_t % T == 0 and qp_t >= nn.shape[0]
    np.testing.assert_array_equal(sp_t.diag_blocks.numpy(), np.asarray(sp_j.diag_blocks))
    ref = []
    for i in range(qp_j // T):
        r, c, v = (np.asarray(a)[i] for a in (sp_j.blk_rows, sp_j.blk_cols, sp_j.blk_vals))
        keep = r >= (i + 1) * T
        ref += [(i, int(a), int(b), float(x)) for a, b, x in zip(r[keep], c[keep], v[keep])]
    got = _triplets(sp_t)
    assert got == sorted(ref) and len(got) > 0
    coo_j = sorted(zip(*(np.asarray(a).tolist() for a in (sp_j.coo_rows, sp_j.coo_cols,
                                                           sp_j.coo_vals))))
    rows_t = np.repeat(np.arange(qp_t), sp_t.coo_len.numpy())
    assert list(zip(rows_t.tolist(), sp_t.coo_cols.tolist(), sp_t.coo_vals.tolist())) == coo_j
    conv = epsl_sparse_from_numpy(sp_j)
    for a, b in zip(conv, sp_t):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("T", [16, 64])
def test_mme_block_draws_plain_matches_pallas_interpret(T):
    """Kernel 10's contract in float32: the plain version against JAX's
    ``mme_block_draws(interpret=True)`` on an SPD block of scale A + diag,
    with the last 3 sites padded (invd = noise = 0: dx = 0 there).  f32,
    sums in another order: 1e-5 of max |dx|."""
    rng = np.random.default_rng(T)
    Q = rng.normal(size=(T, T))
    W = (Q @ Q.T / T + np.eye(T)).astype(np.float32)
    W[T - 3:] = W[:, T - 3:] = 0.0
    r0 = rng.normal(size=T).astype(np.float32)
    d = np.diag(W)
    ok = d > 0
    invd = np.where(ok, 1.0 / np.where(ok, d, 1.0), 0.0).astype(np.float32)
    noise = np.where(ok, rng.normal(size=T), 0.0).astype(np.float32)
    ref = np.asarray(mme_block_draws(*(jnp.asarray(a) for a in (W, r0, invd, noise)),
                                     interpret=True))
    out = TB.mme_block_draws_plain(*(torch.as_tensor(a) for a in (W, r0, invd, noise)))
    assert out.dtype == torch.float32 and (out.numpy()[T - 3:] == 0).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_mme_sweep_plain_matches_jax_sweeps():
    """The sweep's plain version (the CUDA kernel's contract) and the port's
    blocked_mme_gibbs_sparse in float64 against JAX's sparse scan and its
    dense sweep of the direct path, which the port runs on A packed in
    blocks (same LHS, right-hand side and normals; qe not a multiple of T,
    so with padded sites): 1e-9."""
    rng = np.random.default_rng(5)
    nn, _ = _partition(40, 300, n_g=60, seed=2)
    q, T = nn.shape[0], 16
    sp_t, qp = TG._build_epsl_sparse(nn, T, torch.float64)
    sp_j, _ = G._build_epsl_sparse(nn, T, jnp.float64)
    assert q % T
    counts, b, z = (np.zeros(qp) for _ in range(3))
    counts[:q] = rng.integers(0, 3, q)
    b[:q] = rng.normal(size=q)
    z[:q] = rng.normal(size=q)
    x0 = np.zeros(qp)
    x0[:q] = rng.normal(0, 0.3, q)
    ve, scale = 1.3, 0.7
    A_pad = np.zeros((qp, qp))
    A_pad[:q, :q] = nn.toarray()
    LHS = A_pad * scale + np.diag(counts)
    j = lambda a: jnp.asarray(a)
    xs_j, Ae_j = G.blocked_mme_gibbs_sparse(sp_j, j(counts), j(scale), j(x0), j(b), j(ve), j(z))
    xd_j = G.blocked_mme_gibbs(j(LHS[:q, :q]), j(np.diag(LHS)[:q]), j(x0[:q]), j(b[:q]),
                               j(ve), j(z[:q]), q)
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    res = t(b) - scale * t(A_pad @ x0) - t(counts) * t(x0)
    x_plain, _ = TB.mme_sweep_plain(sp_t, t(counts), scale, ve, t(z), t(x0), res)
    xs_t, Ae_t = TG.blocked_mme_gibbs_sparse(sp_t, t(counts), t(scale), t(x0), t(b), t(ve), t(z))
    for out in (x_plain, xs_t):
        np.testing.assert_allclose(out.numpy(), np.asarray(xs_j), rtol=0, atol=1e-9)
        np.testing.assert_allclose(out.numpy()[:q], np.asarray(xd_j), rtol=0, atol=1e-9)
        assert (out.numpy()[q:] == 0).all()   # padded sites frozen
    np.testing.assert_allclose(Ae_t.numpy(), np.asarray(Ae_j), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# one iteration with the epsilon term
# ---------------------------------------------------------------------------


def _ss_setup(model, layout, seed=6, block=16, m=40):
    """JAX data, spec and a mid-run state of a single-step chain: 100
    genotyped and 70 imputed phenotyped rows, m=40 SNPs (one monomorphic)
    in blocks of 16 (or ``m`` in blocks of ``block``),
    a covariate and a 4-level factor, qe=310 sites from a 400-id pedigree's
    A-inverse(nn) (sparse, tile 16, or dense), and a state with sparse g,
    J_beta, epsilon and residuals consistent with them."""
    rng = np.random.default_rng(seed)
    nn, _ = _partition(50, 350, n_g=90, seed=seed)
    qe, n_g, ne = nn.shape[0], 100, 70
    M = rng.binomial(2, 0.3, (n_g + ne, m)).astype(np.float64)
    M[n_g:] = rng.uniform(0, 2, (ne, m))       # imputed dosages
    M[:, 3] = 1.0
    codes = np.sort(rng.choice(qe, ne, replace=False))
    yJ = np.concatenate([-np.ones(n_g), rng.uniform(-1, 0, ne)])
    n = n_g + ne
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    C = rng.normal(size=(n, 1))
    fcodes = rng.integers(0, 4, n)
    nf, pi, fold = ((4, np.array([0.95, 0.02, 0.02, 0.01]), np.array([0.0, 1e-4, 1e-3, 1e-2]))
                    if model == "BayesR" else
                    (2, np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
                     else np.array([0.95, 0.05]), None))
    data = G.prepare_gibbs_data(
        y, M, C=C, r_codes=(fcodes,), r_nlevels=(4,), fold=fold, epsl_yJ=yJ,
        epsl_A=nn if layout == "sparse" else nn.toarray(), epsl_codes=codes, qe=qe,
        block=block, dtype=jnp.float64)
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=1)
    qe_pad = int(data.epsl_counts.shape[0])
    spec = G.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]),
        block=int(data.X_blocks.shape[2]), nc=1,
        nlevels=(4,), n_fold=nf, niter=40, nburn=0, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        ne=ne, qe=qe, qe_pad=qe_pad, resync_every=0)
    st = G.init_state(spec, data, pr, pi)
    g = np.where((rng.random(spec.m_pad) < 0.3) & np.asarray(data.real),
                 rng.normal(0, 0.05, spec.m_pad), 0.0)
    eps = np.zeros(qe_pad)
    eps[:qe] = rng.normal(0, 0.2, qe)
    J = 0.3
    Xb = np.asarray(data.X_blocks)
    u = Xb.transpose(1, 0, 2).reshape(n, -1) @ g + J * yJ
    u[n - ne:] += eps[codes]
    state = st._replace(g=jnp.asarray(g), J_beta=jnp.asarray(J), epsl_estR=jnp.asarray(eps),
                        vepstmp=jnp.asarray(0.4), veps=jnp.asarray(0.4),
                        yadj=st.yadj - jnp.asarray(u), u=jnp.asarray(u), it=jnp.asarray(3))
    return spec, data, state, (y, M, C, fcodes, fold, yJ, nn, codes, qe)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("model", MODELS)
def test_one_iteration_with_epsilon_f64_matches_jax(model, layout):
    """One full iteration with the J and epsilon terms (A-inverse sparse, or
    dense as on the direct path; both through mme_sweep's plain version) from
    the same state with JAX's random numbers: every ChainState field to
    rtol 1e-9 (atol 1e-9 of the field's scale)."""
    spec, data, state, _ = _ss_setup(model, layout)
    key = jax.random.PRNGKey(8)
    ref = G.one_iteration(spec, data, key, state)
    out = TG.one_iteration(port_spec(spec), gibbs_data_from_numpy(data), 0,
                           chain_state_from_numpy(state), noise=JaxNoise(key, int(state.it)))
    assert float(out.J_beta) != 0.3 and float(out.veps) != 0.4   # the term was drawn
    for name in TG.ChainState._fields[1:]:
        r, o = getattr(ref, name), getattr(out, name)
        for a, b in (zip(r, o) if isinstance(o, tuple) else [(r, o)]):
            a, b = np.asarray(a), b.numpy()
            if name == "track":
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=1e-9, atol=1e-9 * (np.abs(a).max() if a.size else 0),
                    err_msg=name)


def test_prepare_and_init_with_epsilon_match_jax():
    """prepare_gibbs_data's single-step fields and init_state's epsilon
    fields against JAX's, bitwise; the dense A is packed as the sparse one
    is, and as convert.py packs JAX's dense field; pad_n is refused with the
    term."""
    spec, data, _, (y, M, C, fcodes, fold, yJ, nn, codes, qe) = _ss_setup("BayesCpi", "dense")
    out = TG.prepare_gibbs_data(y, M, C=C, r_codes=(fcodes,), r_nlevels=(4,), epsl_yJ=yJ,
                                epsl_A=nn.toarray(), epsl_codes=codes, qe=qe, block=16,
                                dtype=torch.float64)
    for name in ("epsl_yJ", "epsl_codes", "epsl_counts", "y", "X_blocks"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(data, name)), err_msg=name)
    assert out.epsl_counts.shape == (qe,)   # the chain's sites stay unpadded
    packed, _ = TG._build_epsl_sparse(nn, 16, torch.float64)
    conv = gibbs_data_from_numpy(data).epsl_sp
    for a, b, c in zip(out.epsl_sp, packed, conv):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(c.numpy(), b.numpy())
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), 0.95, nr=1)
    ref = G.init_state(spec, data, pr, np.array([0.95, 0.05]))
    st = TG.init_state(port_spec(spec), out, pr, np.array([0.95, 0.05]))
    for name in ("J_beta", "epsl_estR", "vepstmp", "veps"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(ref, name)))
    with pytest.raises(ValueError, match="pad_n"):
        TG.prepare_gibbs_data(y, M, epsl_yJ=yJ, epsl_A=nn, epsl_codes=codes, qe=qe,
                              pad_n=True)


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


def _ss_problem(seed=7, nfound=80, nkid=520, n_g=200, m=100, n_causal=10, n_pg=150,
                n_pn=200):
    """A 600-id pedigree, 200 genotyped (int8, m=100), and phenotypes with
    h2 = 0.5 from 10 causal SNPs for 150 genotyped and 200 non-genotyped
    ids, the genotypes dropped down the pedigree (each parent passes one of
    its alleles)."""
    rng = np.random.default_rng(seed)
    ids, sires, dams = _random_pedigree(nfound, nkid, seed=seed)
    pos = {v: i for i, v in enumerate(ids)}
    p = rng.uniform(0.1, 0.5, m)
    geno = np.zeros((len(ids), m), np.int8)
    geno[:nfound] = rng.binomial(2, p, (nfound, m))
    for k in range(nfound, len(ids)):
        for par in (pos[sires[k]], pos[dams[k]]):
            geno[k] += rng.random(m) < geno[par] / 2.0
    b = np.zeros(m)
    b[rng.choice(m, n_causal, replace=False)] = rng.normal(0, 1, n_causal)
    gv = geno @ b
    gv = (gv - gv.mean()) / gv.std() * np.sqrt(0.5)
    y_all = gv + rng.normal(0, np.sqrt(0.5), len(ids))
    gi = np.sort(rng.choice(len(ids), n_g, replace=False))
    others = np.setdiff1d(np.arange(len(ids)), gi)
    phe = np.concatenate([rng.choice(gi, n_pg, replace=False),
                          rng.choice(others, n_pn, replace=False)])
    return dict(data={"id": ids[phe], "y": y_all[phe]}, M=geno[gi], M_id=ids[gi],
                pedigree={"id": ids, "sire": sires, "dam": dams},
                ng_phen=ids[np.setdiff1d(phe, gi)], gv=dict(zip(ids, gv)))


@pytest.mark.parametrize("impute", ["direct", "pcg"])
def test_ssbrm_posterior_agrees_with_jax(impute):
    """Same data, one chain each of 300 iterations (100 burn-in, 40 kept
    records): the packages draw different random streams, so the
    posterior-mean GEBV of all 600 pedigree ids differ by Monte Carlo error
    only.  Measured corr 0.970-0.989 over data seeds 7-9 and both paths
    (0.980 direct and 0.982 pcg at this seed); the bar 0.95 leaves room for
    Monte Carlo error and still fails a wrong epsilon or imputation term.
    Both track the simulated truth of the 200 non-genotyped phenotyped ids
    alike: accuracies 0.68-0.80, differing by at most 0.017 (bar 0.05)."""
    prob = _ss_problem()
    kw = dict(method="BayesCpi", niter=300, nburn=100, verbose=False, impute=impute,
              chunk_cols=32)
    keys = ("data", "M", "M_id", "pedigree")
    ref = jax_ssbrm("y~1", **{k: prob[k] for k in keys}, **kw)
    out = htt.ssbrm("y~1", **{k: prob[k] for k in keys}, device="cpu", **kw)
    assert list(out.g["id"]) == list(ref.g["id"]) and len(out.g["id"]) == 600
    corr = np.corrcoef(ref.g["gebv"], out.g["gebv"])[0, 1]
    assert corr >= 0.95, corr
    assert abs(ref.h2 - out.h2) < 0.1 and out.Veps > 0 and np.isfinite(out.J)
    acc = []
    for fit in (ref, out):
        gm = dict(zip(fit.g["id"], fit.g["gebv"]))
        acc.append(np.corrcoef([gm[i] for i in prob["ng_phen"]],
                               [prob["gv"][i] for i in prob["ng_phen"]])[0, 1])
    assert abs(acc[0] - acc[1]) < 0.05 and acc[1] > 0.6, acc
    assert out.e["e"].shape == (350,) and np.isfinite(out.e["e"]).all()
    assert set(out.setup_seconds) == {"pedigree", "imputation", "prepare"}


def test_ssbrm_ne0_large_n_row_padding():
    """tests/test_ssbrm.py:412 for the port: with every phenotyped id
    genotyped the epsilon arguments are dropped (a warning), and n=5,000 >
    4,096 makes prepare_gibbs_data pad the rows: spec n / n_real carry the
    padded and the real count, and the fit is finite."""
    rng = np.random.default_rng(11)
    ids, sires, dams = _random_pedigree(200, 300, seed=9)
    n_g, m = 5000, 64
    geno_ids = np.concatenate([rng.choice(ids, 100, replace=False),
                               np.array([f"G{i}" for i in range(n_g - 100)])])
    M = rng.binomial(2, 0.35, (n_g, m)).astype(np.int8)
    with pytest.warns(UserWarning, match="imputation errors"):
        fit = htt.ssbrm("y~1", data={"id": geno_ids, "y": rng.normal(0, 1, n_g)}, M=M,
                        M_id=geno_ids, pedigree={"id": ids, "sire": sires, "dam": dams},
                        method="BayesCpi", niter=20, nburn=10, thin=5, verbose=False,
                        device="cpu")
    assert np.isfinite(fit.Vg) and np.isfinite(fit.Ve) and fit.Veps is None
    assert np.isfinite(fit.g["gebv"]).all() and len(fit.g["id"]) == 5400


def test_ssbrm_refusals():
    """BSLMM is refused as in JAX (ValueError); a mesh runs (a one-rank
    mesh: the one-device fit bit for bit); without a card, device=None
    raises.  (Checkpoints and chain batches are ported:
    tests/test_torch_checkpoint.py, tests/test_torch_multichain_ssbrm.py.)"""
    prob = _ss_problem(nkid=120, n_g=60, m=20, n_pg=30, n_pn=40)
    kw = {k: prob[k] for k in ("data", "M", "M_id", "pedigree")}
    with pytest.raises(ValueError, match="BSLMM"):
        htt.ssbrm("y~1", method="BSLMM", device="cpu", **kw)
    fit_kw = dict(niter=20, nburn=10, verbose=False, device="cpu", **kw)
    np.testing.assert_array_equal(htt.ssbrm("y~1", mesh=make_mesh(), **fit_kw).alpha,
                                  htt.ssbrm("y~1", **fit_kw).alpha)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            htt.ssbrm("y~1", niter=20, nburn=10, **kw)
