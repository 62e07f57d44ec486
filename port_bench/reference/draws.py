"""One SNP draw of the Bayesian alphabet, for every SNP at once given its
right-hand side, and the judgement of a chain's draws against it.

The sequential sweep draws SNP j from its conditional given rhs_j =
X_j' r + x_j g_j (x_j = X_j' X_j), where r is the residual after SNPs 0 ..
j-1 were drawn.  Given rhs, every component of the mixture has a score (a
log-probability up to a shared constant, its Gumbel or logistic noise
included), the component of highest score is drawn, and its effect is
rhs / v_c + sqrt(ve / v_c) z with v_c = x + ve / var_c (reference
src/Bayes.cpp:614-700, the JAX package's _draw_from_vals).  The scores put
every choice on one scale: a choice that another computation makes
differently lies below the best by a gap in log-probability, which is
small where rounding alone moved it and large where the draw is wrong.

Supported: BayesR (folds drawn by Gumbel-max) and BayesCpi (one slab,
drawn by a logistic threshold), with the SBayesS guard (a nonzero draw with
g^2 vx > vary is replaced by the next of 8 pre-drawn candidates, else 0).
"""

from __future__ import annotations

import torch

NEG_BIG = -1e30
SAME_CANDIDATE = 1e-3   # sds within which two guard candidates are taken as one


def components(model: str, rhs, x, ve, act, logpi, vara_fold, varg, z, u):
    """Scores, effects and their sds of every component, (K, m, C) each.

    rhs (K, m); x (m,) = X_j' X_j; ve (K, m) the residual variance each SNP
    sees; act (m,) SNPs that can take an effect; logpi (K, C); vara_fold
    (K, C) the folds' variances (BayesR); varg (K,) the slab's (BayesCpi);
    z (K, m) normals; u (K, m, C) (BayesR) or (K, m) (BayesCpi) uniforms.
    Component 0 is the zero effect (score, effect and sd 0 for BayesCpi's
    reference level)."""
    dt = rhs.dtype
    zero = torch.zeros((), dtype=dt, device=rhs.device)
    q = rhs * rhs
    if model == "BayesR":
        gum = -torch.log(-torch.log(torch.clamp_min(u.to(dt), 1e-12)))
        scores = [logpi[:, 0, None] + gum[..., 0]]
        effects, sds = [torch.zeros_like(rhs)], [torch.zeros_like(rhs)]
        for f in range(1, logpi.shape[1]):
            var_f = torch.clamp_min(vara_fold[:, f, None], 1e-30)
            v = x + ve / var_f
            s = (-0.5 * torch.log(var_f * x / ve + 1.0) + logpi[:, f, None] + gum[..., f]
                 + q / (2.0 * v * ve))
            scores.append(torch.where(act, s, NEG_BIG))
            sd = torch.where(act, torch.sqrt(ve / v), zero)
            effects.append(torch.where(act, rhs / v, zero) + sd * z)
            sds.append(sd)
    elif model == "BayesCpi":
        var1 = varg[:, None]
        v = x + ve / var1
        lu = torch.log((1.0 - u.to(dt)) / torch.clamp_min(u.to(dt), 1e-37))
        s1 = (q / (2.0 * v * ve) - lu - 0.5 * torch.log(var1 * x / ve + 1.0)
              + (logpi[:, 1] - logpi[:, 0])[:, None])
        scores = [torch.zeros_like(rhs), torch.where(act, s1, NEG_BIG)]
        sd = torch.where(act, torch.sqrt(ve / v), zero)
        effects = [torch.zeros_like(rhs), torch.where(act, rhs / v, zero) + sd * z]
        sds = [torch.zeros_like(rhs), sd]
    else:
        raise ValueError(f"the reference draws BayesR and BayesCpi, not {model}")
    return torch.stack(scores, -1), torch.stack(effects, -1), torch.stack(sds, -1)


def best(model: str, scores):
    """The component drawn: the highest score, ties to the lowest index
    (BayesR), or the slab where its score is >= 0 (BayesCpi)."""
    if model == "BayesCpi":
        return (scores[..., 1] >= scores[..., 0]).to(torch.int64)
    return torch.argmax(scores, dim=-1)


def guard_candidates(first, rhs, x, ve, varg, zr):
    """The guard's candidates of a BayesCpi slab draw, (K, m, 10): the first
    draw, the 8 pre-drawn ones (rhs / v + sd z_t, zr (K, 8, m)) and 0."""
    v = x + ve / varg[:, None]
    sd = torch.sqrt(ve / v)
    cands = [first] + [rhs / v + sd * zr[:, t] for t in range(zr.shape[1])]
    return torch.stack(cands + [torch.zeros_like(first)], -1)


def guard_accept(cands, vx, vary):
    """Index of the candidate the guard keeps: the first with g^2 vx <= vary,
    else the last (0)."""
    ok = cands[..., :-1] ** 2 * vx[:, None] <= vary
    ok = torch.cat([ok, torch.ones_like(ok[..., :1])], -1)
    return torch.argmax(ok.to(torch.int8), dim=-1)


def judge(model, scores, effects, sds, g_out, track_out, act, guard=None):
    """Per SNP (K, m): the choice gap (the best score less the score of the
    component the chain drew; 0 where they agree) and the effect gap (the
    chain's effect against the reference's effect of the component it drew,
    in that component's sds; infinite for a nonzero effect of the zero
    component or of a SNP that can take none).

    ``guard`` (BayesCpi with the SBayesS guard): (candidates (K, m, 10) of
    the reference, the index it keeps, vx (m,), vary).  The chain's effect
    is matched to its nearest candidate; where it kept another candidate
    than the reference, the choice gap is the reference's margin at the
    first candidate on which they part, |log(g^2 vx / vary)|.  Returns
    (choice_gap, effect_gap, kept index of the chain or None)."""
    dt = scores.dtype
    tr = track_out.to(torch.int64).clamp(0, scores.shape[-1] - 1)
    bad_track = (track_out.to(torch.int64) != tr)
    ref = best(model, scores)
    sc_ref = torch.gather(scores, -1, ref[..., None])[..., 0]
    sc_out = torch.gather(scores, -1, tr[..., None])[..., 0]
    choice_gap = torch.where(tr == ref, torch.zeros_like(sc_ref), sc_ref - sc_out)
    choice_gap = torch.where(bad_track, torch.full_like(choice_gap, float("inf")), choice_gap)
    g = g_out.to(dt)
    sd = torch.gather(sds, -1, tr[..., None])[..., 0]
    eff = torch.gather(effects, -1, tr[..., None])[..., 0]
    kept_out = None
    if guard is not None:
        cands, kept_ref, vx, vary = guard
        dist = (g[..., None] - cands).abs() / torch.where(sd > 0, sd, 1.0)[..., None]
        near = dist.min(-1).values
        # the candidate the chain kept: the first as near as the nearest, to
        # SAME_CANDIDATE sds (the guard keeps the first that passes, and two
        # candidates can coincide to rounding)
        kept_out = torch.argmax((dist <= near[..., None] + SAME_CANDIDATE).to(torch.int8), -1)
        on = tr > 0
        first = torch.minimum(kept_out, kept_ref).clamp_max(cands.shape[-1] - 2)
        c = torch.gather(cands, -1, first[..., None])[..., 0]
        margin = torch.log(c * c * vx / vary).abs()
        parted = on & (tr == ref) & (kept_out != kept_ref)
        choice_gap = torch.where(parted, torch.maximum(choice_gap, margin), choice_gap)
    nonzero = tr > 0
    eff_gap = torch.where(nonzero & (sd > 0), (g - eff).abs() / torch.where(sd > 0, sd, 1.0),
                          torch.zeros_like(g))
    if guard is not None:   # the nearest candidate's gap
        eff_gap = torch.where(nonzero & (sd > 0), near, eff_gap)
    wrong_zero = (~nonzero | ~act) & (g != 0) & ~(nonzero & (sd > 0))
    eff_gap = torch.where(wrong_zero, torch.full_like(g, float("inf")), eff_gap)
    return choice_gap, eff_gap, kept_out
