"""The port's library samplers and solvers (hibayes_tpu_torch/math/
distributions.py, solvers.py) against analytic moments, as
tests/test_distributions.py holds the JAX package's, and their
deterministic transforms and solvers against the JAX package's on the same
inputs in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.math import distributions as JD
from hibayes_tpu.math import solvers as JS
from hibayes_tpu_torch.math import distributions as D
from hibayes_tpu_torch.math import solvers as S

N = 200_000
F64 = torch.float64


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_every_public_function_is_ported():
    for mod, ref in ((D, JD), (S, JS)):
        names = {n for n in dir(ref) if not n.startswith("_") and callable(getattr(ref, n))
                 and getattr(getattr(ref, n), "__module__", "") == ref.__name__}
        assert names <= set(dir(mod)), names - set(dir(mod))


def test_chisq_moments():
    for df in [1.0, 4.0, 50.0]:
        x = D.chisq(_gen(), df, (N,), dtype=F64)
        assert abs(float(x.mean()) - df) < 0.05 * df + 0.05
        assert abs(float(x.var()) - 2 * df) < 0.1 * df + 0.3


def test_inv_chisq_mean():
    # scaled-inv-chi2(df, s) has mean df*s/(df-2)
    df, s = 10.0, 3.0
    x = D.inv_chisq(_gen(), df, s, (N,), dtype=F64)
    assert abs(float(x.mean()) - df * s / (df - 2)) < 0.1


def test_inv_gaussian_moments():
    mu, lam = 2.0, 5.0
    x = D.inv_gaussian(_gen(), mu, lam, (N,), dtype=F64)
    assert abs(float(x.mean()) - mu) < 0.02 * mu
    assert abs(float(x.var()) - mu**3 / lam) < 0.1 * mu**3 / lam


def test_dirichlet_mean():
    alpha = np.array([2.0, 3.0, 5.0])
    gen = _gen()
    xs = torch.stack([D.dirichlet(gen, torch.as_tensor(alpha), dtype=F64) for _ in range(20000)])
    np.testing.assert_allclose(xs.mean(0).numpy(), alpha / alpha.sum(), atol=0.01)
    np.testing.assert_allclose(xs.sum(1).numpy(), 1.0, rtol=1e-12)


def test_laplace_moments():
    x = D.laplace(_gen(), 1.0, 2.0, (N,), dtype=F64)
    assert abs(float(x.mean()) - 1.0) < 0.03
    assert abs(float(x.var()) - 2 * 4.0) < 0.2


def test_gamma_scale():
    x = D.gamma(_gen(), 3.0, (N,), dtype=F64, scale=2.0)
    assert abs(float(x.mean()) - 6.0) < 0.1
    y = D.inv_gamma(_gen(), 5.0, 2.0, (N,), dtype=F64)   # mean scale / (alpha - 1)
    assert abs(float(y.mean()) - 0.5) < 0.01


@pytest.mark.parametrize("name,args,mean,var", [
    ("normal", (1.5, 2.0), 1.5, 4.0),
    ("uniform", (), 0.5, 1.0 / 12.0),
    ("beta", (2.0, 3.0), 0.4, 0.04),
    ("student_t", (5.0,), 0.0, 5.0 / 3.0),
    ("exponential", (2.0,), 2.0, 4.0),
])
def test_moments(name, args, mean, var):
    x = getattr(D, name)(_gen(1), *args, shape=(N,), dtype=F64)
    assert x.dtype == F64 and x.shape == (N,)
    assert abs(float(x.mean()) - mean) < 0.02 * max(1.0, abs(mean)) + 0.01
    assert abs(float(x.var()) - var) < 0.05 * var + 0.01


def test_cauchy_quantiles():
    """The Cauchy has no moments: its quartiles are location -/+ scale."""
    x = D.cauchy(_gen(2), 1.0, 3.0, (N,), dtype=F64)
    q = torch.quantile(x[:100_000], torch.tensor([0.25, 0.5, 0.75], dtype=F64)).numpy()
    np.testing.assert_allclose(q, [-2.0, 1.0, 4.0], atol=0.1)


def test_transforms_equal_jax():
    """scaled_inv_chisq_from, laplace_from and inv_gaussian_from equal the
    JAX package's on the same inputs to 1e-12 in f64."""
    rng = np.random.default_rng(4)
    z, u = rng.normal(size=1000), rng.random(1000)
    mu, lam = rng.uniform(0.1, 3.0, 1000), rng.uniform(0.5, 5.0, 1000)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))
    j = lambda a: jnp.asarray(a, dtype=jnp.float64)
    pairs = [
        (D.inv_gaussian_from(t(z), t(u), t(mu), t(lam)),
         JD.inv_gaussian_from(j(z), j(u), j(mu), j(lam))),
        (D.laplace_from(t(u), 0.3, 1.7), JD.laplace_from(j(u), 0.3, 1.7)),
        (D.scaled_inv_chisq_from(t(mu), 2.0, 6.0, t(lam)),
         JD.scaled_inv_chisq_from(j(mu), 2.0, 6.0, j(lam))),
    ]
    for out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    assert float(D.scaled_inv_chisq_from(10.0, 2.0, 6.0, 4.0)) == (10.0 + 2.0) / 4.0


def _spd(m=40, seed=3):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(m, m))
    return B @ B.T + m * np.diag(1.0 + rng.random(m)), rng.normal(size=m)


def test_estimate_diag_and_pcg_probe():
    """The probe-estimated Jacobi preconditioner approximates diag(A) and
    pcg still converges to the true solve (tests/test_distributions.py's
    check)."""
    A, b = _spd()
    At = torch.from_numpy(A)
    matvec = lambda v: At @ v
    d = S.estimate_diag(matvec, 40, nprobes=256).numpy()
    assert np.allclose(d, np.diag(A), rtol=0.35)
    x, it = S.pcg(matvec, torch.from_numpy(b), tol=1e-10)
    assert 0 < it <= 40
    assert np.allclose((At @ x).numpy(), b, atol=1e-6)


@pytest.mark.parametrize("diag", [True, False], ids=["jacobi", "none"])
def test_pcg_with_diag_equals_jax(diag):
    """pcg_with_diag takes JAX's steps: the same iterations and the same
    solution to 1e-10 in f64, with the true diagonal or none."""
    A, b = _spd(seed=5)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    d = np.diag(A).copy() if diag else None
    x, it = S.pcg_with_diag(lambda v: At @ v, torch.from_numpy(b),
                            None if d is None else torch.from_numpy(d), tol=1e-9)
    xj, itj = JS.pcg_with_diag(lambda v: Aj @ v, jnp.asarray(b),
                               None if d is None else jnp.asarray(d), tol=1e-9)
    assert it == int(itj)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
