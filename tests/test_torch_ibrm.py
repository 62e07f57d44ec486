"""End-to-end `ibrm` of the port on the CPU: synthetic recovery, posterior
agreement with the JAX package, and no JAX import."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import hibayes_tpu as hj
import hibayes_tpu_torch as ht

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic(seed=11, n=300, m=200, n_causal=20, h2=0.5):
    """int8 genotypes, 20 causal SNPs, phenotype with heritability h2."""
    rng = np.random.default_rng(seed)
    M = rng.binomial(2, rng.uniform(0.1, 0.5, m), size=(n, m)).astype(np.int8)
    b = np.zeros(m)
    causal = rng.choice(m, n_causal, replace=False)
    b[causal] = rng.normal(0, 1, n_causal)
    gv = M @ b
    gv = (gv - gv.mean()) / gv.std() * np.sqrt(h2)
    y = gv + rng.normal(0, np.sqrt(1 - h2), n)
    ids = np.array([f"i{k}" for k in range(n)])
    return M, {"id": ids, "T1": y}, ids, gv


@pytest.mark.parametrize("method", ["BayesCpi", "BayesR"])
def test_ibrm_h2_recovery_synthetic(method):
    """tests/test_ibrm.py's recovery bar, cut to n=300, m=200 and 200
    iterations (100 burn-in) so the plain CPU sweep runs in seconds."""
    M, data, ids, gv = _synthetic()
    fit = ht.ibrm("T1~1", data=data, M=M, M_id=ids, method=method,
                  niter=200, nburn=100, verbose=False, device="cpu")
    assert abs(fit.h2 - 0.5) < 0.12
    assert np.corrcoef(fit.g["gebv"], gv)[0, 1] > 0.85
    assert fit.alpha.shape == (200,) and np.isfinite(fit.alpha).all()
    assert ((fit.pip >= 0) & (fit.pip < 1)).all()


def test_posterior_gebv_agrees_with_jax():
    """Same data, same model, one chain each.  The packages draw different
    random streams, so the posterior means differ by Monte Carlo error
    only: with 80 kept records each, the posterior-mean GEBV correlate at
    >= 0.99 (0.995-0.997 over three data seeds)."""
    M, data, ids, _ = _synthetic()
    kw = dict(method="BayesCpi", niter=600, nburn=200, verbose=False)
    ref = hj.ibrm("T1~1", data=data, M=M, M_id=ids, **kw)
    out = ht.ibrm("T1~1", data=data, M=M, M_id=ids, device="cpu", **kw)
    assert np.corrcoef(ref.g["gebv"], out.g["gebv"])[0, 1] >= 0.99
    assert abs(ref.h2 - out.h2) < 0.05


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import hibayes_tpu_torch as ht
        rng = np.random.default_rng(0)
        M = rng.binomial(2, 0.3, size=(40, 24)).astype(np.int8)
        ids = np.array([f"i{k}" for k in range(40)])
        data = {"id": ids, "T1": rng.normal(size=40), "f": np.repeat(["a", "b"], 20)}
        fit = ht.ibrm("T1 ~ (1|f)", data=data, M=M, M_id=ids, method="BayesR",
                      niter=12, nburn=6, thin=2, verbose=False, device="cpu")
        assert np.isfinite(fit.h2)
        # sbrm on dense LD, on tiled LD (two tile rows of 128) and by CG
        m = 256
        R = 0.5 ** np.abs(np.arange(m)[:, None] - np.arange(m)[None, :])
        R[np.abs(np.arange(m)[:, None] - np.arange(m)[None, :]) > 8] = 0.0
        b = np.where(rng.random(m) < 0.05, rng.normal(0, 0.1, m), 0.0)
        ss = np.column_stack([np.full(m, 0.3), R @ b, np.full(m, 0.01),
                              np.full(m, 10000.0)])
        tiled = ht.TiledSparseLD.from_dense(R, tile=128)
        for ld, method in ((R, "BayesCpi"), (tiled, "BayesR"), (tiled, "CG")):
            fit = ht.sbrm(ss, ld, method=method, niter=12, nburn=6, thin=2,
                          verbose=False, device="cpu")
            assert np.isfinite(fit.alpha).all() and np.isfinite(fit.h2)
        # ssbrm on a 300-id pedigree, both imputation paths
        ids = np.array([f"p{k}" for k in range(300)])
        par = [rng.integers(0, max(k, 1), 2) for k in range(300)]
        sires = np.array(["0" if k < 40 else ids[p[0]] for k, p in enumerate(par)])
        dams = np.array(["0" if k < 40 else ids[p[1]] for k, p in enumerate(par)])
        gid = ids[rng.choice(300, 80, replace=False)]
        Mg = rng.binomial(2, 0.3, size=(80, 30)).astype(np.int8)
        phe = ids[rng.choice(300, 120, replace=False)]
        for impute in ("direct", "pcg"):
            fit = ht.ssbrm("y ~ 1", data={"id": phe, "y": rng.normal(size=120)}, M=Mg,
                           M_id=gid, pedigree={"id": ids, "sire": sires, "dam": dams},
                           niter=12, nburn=6, thin=2, verbose=False, impute=impute,
                           device="cpu")
            assert np.isfinite(fit.g["gebv"]).all() and np.isfinite(fit.Veps)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "hibayes_tpu"))
        assert not bad, bad
        print("no-jax-ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout
