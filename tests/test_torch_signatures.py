"""The port's entry points against the JAX package's, on the CPU: the same
keywords in the same order (plus ``device``), the unported ones refused
with their ROADMAP item, the ported ones reaching the engine, and
refusals that cite only work still to do."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import hibayes_tpu as hj
import hibayes_tpu_torch as ht
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["ibrm", "sbrm", "ssbrm"])
def test_entry_point_keywords_match_the_reference(name):
    """Every keyword of hibayes_tpu's entry point, in its order; the port
    adds only ``device``, last."""
    ref = list(inspect.signature(getattr(hj, name)).parameters)
    port = list(inspect.signature(getattr(ht, name)).parameters)
    assert port == ref + ["device"]


@pytest.mark.parametrize("name,extra", [("read_plink", ["snps"]), ("read_pheno", []),
                                        ("ldmat", ["device"]),
                                        ("build_tiled_ld", ["device"])])
def test_io_and_ld_keywords_match_the_reference(name, extra):
    """The host I/O and LD construction take the JAX package's keywords in
    its order; read_plink adds only ``snps`` (a rank's SNP range), ldmat and
    build_tiled_ld only ``device``, last."""
    ref = list(inspect.signature(getattr(hj, name)).parameters)
    port = list(inspect.signature(getattr(ht, name)).parameters)
    assert port == ref + extra


def test_all_covers_the_reference():
    """Every public name of hibayes_tpu is public in the port, ``plot``
    (loaded lazily) included."""
    assert set(hj.__all__) <= set(ht.__all__)
    for name in hj.__all__:
        assert getattr(ht, name) is not None, name


def _ibrm_data(n=60, m=40, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    ids = np.array([f"i{k}" for k in range(n)])
    return M, {"id": ids, "T1": y}, ids


@pytest.mark.parametrize("kw,item", [
    ({"lambda_": 0.5}, "item 9"),
    ({"checkpoint": "fit.ckpt"}, "item 7"),
    ({"mesh": make_mesh()}, None),
    ({"shard_schedule": "concurrent"}, None),
    ({"merge_rounds": 2}, None),
    ({"emulate_shards": 2}, None),
], ids=["lambda_", "checkpoint", "mesh", "shard_schedule", "merge_rounds",
        "emulate_shards"])
def test_ibrm_refuses_unported_keywords_by_item(kw, item, tmp_path, monkeypatch):
    """Every mesh keyword runs as in the JAX package (a one-rank mesh; with
    the "turn" schedule ``merge_rounds`` changes nothing, and
    ``emulate_shards`` only pads the blocks to a multiple of it;
    "concurrent" without a mesh or emulate_shards is the exact chain: the
    "turn" fit bit for bit).  ``lambda_`` (item 9, BSLMM) and ``checkpoint`` (item 7) are
    ported: the keyword reaches the engine.  A BSLMM fit with lambda_=0.5 runs on the ridged GRM (its
    eigenvalues, all at least 0.5, in the chain's data); checkpoint= writes
    <path>.npz with the finished chain."""
    M, data, ids = _ibrm_data()
    fit_kw = dict(data=data, M=M, M_id=ids, niter=20, nburn=10, verbose=False, device="cpu")
    if "lambda_" in kw:
        seen = {}
        real = TG.prepare_gibbs_data

        def spy(*a, **k):
            seen["Kval"] = k["Kval"]
            return real(*a, **k)

        monkeypatch.setattr(TG, "prepare_gibbs_data", spy)
        fit = ht.ibrm("T1~1", method="BSLMM", **kw, **fit_kw)
        assert float(seen["Kval"].min()) >= 0.5 - 1e-5
        assert np.isfinite(fit.Vb) and np.isfinite(fit.Va)
        return
    if "checkpoint" in kw:
        ck = str(tmp_path / kw["checkpoint"])
        ht.ibrm("T1~1", checkpoint=ck, **fit_kw)
        assert os.path.exists(ck + ".npz")
        assert json.load(open(ck + ".meta.json"))["it"] == 20
        return
    fit = ht.ibrm("T1~1", **fit_kw, **kw)
    assert np.isfinite(fit.alpha).all()
    if "emulate_shards" not in kw:   # which pads the blocks to a multiple of 2
        np.testing.assert_array_equal(fit.alpha, ht.ibrm("T1~1", **fit_kw).alpha)


def test_threads_is_accepted_and_unused():
    """``threads`` (the JAX package's host codec threads) changes nothing:
    ibrm and sbrm fits with and without it are bit for bit the same."""
    M, data, ids = _ibrm_data()
    kw = dict(data=data, M=M, M_id=ids, niter=20, nburn=10, seed=3, verbose=False,
              device="cpu")
    a = ht.ibrm("T1~1", threads=4, **kw)
    b = ht.ibrm("T1~1", **kw)
    np.testing.assert_array_equal(a.g["gebv"], b.g["gebv"])
    m = 64
    R = 0.5 ** np.abs(np.arange(m)[:, None] - np.arange(m)[None, :])
    beta = R @ np.where(np.arange(m) % 9 == 0, 0.1, 0.0)
    ss = np.column_stack([np.full(m, .3), beta, np.full(m, .01), np.full(m, 1e4)])
    skw = dict(method="BayesCpi", niter=20, nburn=10, seed=3, verbose=False, device="cpu")
    np.testing.assert_array_equal(ht.sbrm(ss, R, threads=4, **skw).alpha,
                                  ht.sbrm(ss, R, **skw).alpha)


def test_summary_spec_refusal_names_the_summary_engine():
    """A summary-level spec that reaches the individual-level engine is
    sent to engine/sgibbs.py; the refusal no longer calls the summary
    engine (ROADMAP items 10-11, done) unported."""
    spec = TG.GibbsSpec(model="BayesCpi", n=10, m=8, m_pad=8, block=8, nc=0, nlevels=(),
                        n_fold=2, niter=2, nburn=1, thin=1, nvar0=0, reject_guard=True)
    with pytest.raises(NotImplementedError) as e:
        TG._check_ported(spec, None)
    msg = str(e.value)
    assert "engine/sgibbs.py" in msg
    assert "not ported" not in msg and "10-11" not in msg
