"""What decides ``correct``: the window's own chain against the plain
reference (reference/), once the window has closed.

The chain's states are captured in the window (harness.py:StepHook) at a few
iterations drawn from the seed: the first ``steps`` iterations, ``steps``
iterations from a point t0 inside the window, and a few record iterations.
For each captured stretch the reference follows the chain's own SNP draws
from a start of its own (the chain's first state, worked out from the
inputs; or the chain's parameters at t0, the residual worked out again),
computes every other quantity itself, and judges each SNP draw of every
chain (reference/draws.py:judge):

* ``choice_gap``: the largest gap, in log-probability, by which a component
  (or a guard candidate) the chain drew lies below the reference's choice;
* ``effect_gap``: the largest gap between a chain's effect and the
  reference's effect of the same component, in that component's sds;
* ``guard_tally_gap`` (guarded sweeps): the chain's guard counter against
  the guard decisions its own draws show, per captured iteration (exact);
* ``records_gap``: the chain's records against the states they record
  (exact), at the captured record iterations.

The control is the same reference computed in float32 with TF32 products,
put in the chain's place at the same positions: its choices and effects
are judged by the same numbers and limits, and with ``--control 1`` they,
not the chain's, decide the run's ``correct``.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.draws import best, judge
from .reference.noise import Noise

def tf32(t):
    """``t`` (float32) rounded to TF32, a 10-bit mantissa, to nearest (ties
    away from zero), as the tensor cores round the operands of a TF32
    product: the control's operands, whatever kernel cuBLAS picks for a
    product (a matrix-vector one takes no TF32 path at all)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def plan(seed: int, niter: int, nburn: int, thin: int, steps: int, n_records: int) -> dict:
    """The iterations to capture, drawn from the seed: steps from 0, steps
    from t0, the first record iteration and ``n_records`` more (as many on
    every seed, so that the capture buffers, and the memory peak, are the
    same)."""
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFF)
    t0 = int(rng.integers(steps, max(steps + 1, niter - steps)))
    # the iteration whose result record k keeps: nburn + (k + 1) thin - 1
    recs = list(range(nburn + thin - 1, niter, thin))
    more = rng.choice(recs[1:], size=min(n_records, len(recs) - 1), replace=False)
    pick = [recs[0], *sorted(int(r) for r in more)]
    return {"a": list(range(steps)), "b": list(range(t0, t0 + steps)), "records": pick}


def _control_out(model, comps, guard):
    scores, effects, _ = comps
    choice = best(model, scores)
    g = torch.gather(effects, -1, choice[..., None])[..., 0]
    if guard is not None:
        cands, kept = guard
        g = torch.where(choice == 1, torch.gather(cands, -1, kept[..., None])[..., 0], 0.0)
    return g, choice


def _detail(it, k, j, comps, gd, g_out, track_out, cg, eg, kept) -> str:
    """One draw that failed its limit, for the run's standard error."""
    scores, effects, sds = (c[k, j].tolist() for c in comps)
    text = (f"iteration {it} chain {k} SNP {j}: drew component {int(track_out[k, j])} "
            f"effect {float(g_out[k, j])!r}; reference scores {scores} effects {effects} "
            f"sds {sds}; choice gap {float(cg[k, j])!r} effect gap {float(eg[k, j])!r}")
    if gd is not None:
        text += (f"; guard candidates {gd[0][k, j].tolist()} kept by the reference "
                 f"{int(gd[1][k, j])}, nearest to the chain's {int(kept[k, j])}, "
                 f"vx {float(gd[2][j])!r} vary {float(gd[3])!r}")
    return text


def _side(guarded: bool) -> dict:
    gaps = {"choice_gap": 0.0, "effect_gap": 0.0}
    if guarded:
        gaps["guard_tally_gap"] = 0
    return {"gaps": gaps, "attempted": 0, "failed": 0, "worst": []}


def _judged(side, it, comps, gd, g_out, track_out, model, act, lim_c, lim_e):
    """Judge one iteration's draws of one side against the reference; returns
    the chain's kept guard candidates."""
    cg, eg, kept = judge(model, *comps, g_out, track_out, act, guard=gd)
    r = side["gaps"]
    r["choice_gap"] = max(r["choice_gap"], float(cg.max()))
    r["effect_gap"] = max(r["effect_gap"], float(eg.max()))
    side["attempted"] += int(cg.numel())
    bad = (cg > lim_c) | (eg > lim_e)
    side["failed"] += int(bad.sum())
    for k, j in bad.nonzero().tolist()[:4]:
        side["worst"].append(_detail(it, k, j, comps, gd, g_out, track_out, cg, eg, kept))
    return kept


def follow(fit, hook, seed: int, limits: dict, control: bool = False) -> dict:
    """The readings of the chain, and with ``control`` of the control:
    {"chain": side, "control": side}, a side {"gaps": the compared numbers,
    "attempted", "failed": draws judged and past a limit, "worst": lines on
    failed draws}."""
    K, model = fit.K, fit.cfg["method"]
    ref = fit.reference(torch.float64)
    ctl = fit.reference(torch.float32, tf32) if control else None
    dev = ref.dev
    guarded = ref.guarded
    out = {"chain": _side(guarded)}
    if control:
        out["control"] = _side(False)
    lim = (model, ref.act, limits["choice_gap"], limits["effect_gap"])
    for its, start in ((hook.plan["a"], None), (hook.plan["b"], hook.plan["b"][0])):
        if start is None:
            st, sc = ref.start(K), (ctl.start(K) if control else None)
        else:
            p = fit.params(hook.inp[start], K)
            st = ref.from_chain(p)
            sc = ctl.from_chain(p) if control else None
        for it in its:
            g_out, track_out = fit.draws(hook.out[it], K)
            noises = [Noise(seed, it, k, dev) for k in range(K)]
            res = ref.step(st, noises, g_out, track_out)
            st, comps = res[0], res[1]
            gd = (res[2][0], res[2][1], ref.vx, ref.vary) if guarded else None
            kept = _judged(out["chain"], it, comps, gd, g_out, track_out, *lim)
            if guarded:
                on = track_out.to(torch.int64) == 1
                last = res[2][0].shape[-1] - 1   # the candidate 0 of an exhausted draw
                seen = torch.stack([((kept >= 1) & on).sum(), ((kept == last) & on).sum()]).cpu()
                gap = int((hook.dtally[it].reshape(-1, 2).sum(0).cpu() - seen).abs().sum())
                out["chain"]["gaps"]["guard_tally_gap"] += gap
                out["chain"]["attempted"] += 1
                out["chain"]["failed"] += int(gap > 0)
            if control:
                rc = ctl.step(sc, noises, g_out, track_out)
                sc = rc[0]
                g_c, t_c = _control_out(model, rc[1], rc[2] if guarded else None)
                _judged(out["control"], it, comps, gd, g_c, t_c, *lim)
    return out


def records(fit, hook, samples: dict) -> tuple:
    """(values compared, values that differ) of the captured record
    iterations against the window's records."""
    spec, K, m = hook.spec, fit.K, fit.cfg["m"]
    compared = differ = 0
    for it in hook.plan["records"]:
        k = (it + 1 - spec.nburn) // spec.thin - 1
        if k < 0 or k >= spec.n_records:
            continue
        for name, want in fit.records(hook.out[it], m).items():
            got = samples[name]
            got = got[k] if K == 1 else got[:, k]
            want = want.detach().cpu().numpy().reshape(np.shape(got))
            compared += want.size
            differ += int((np.asarray(got) != want).sum())
    return compared, differ
