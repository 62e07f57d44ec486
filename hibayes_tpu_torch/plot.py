"""Visualization: Manhattan, GWAS QQ, MCMC trace / posterior density plots.

A copy of hibayes_tpu/plot.py for the port (numpy and matplotlib only; it
reads the port's ``BlrMod`` results, the same fields).

The reference delegates all visualization to the re-exported CMplot package
(reference: R/exports.R:17-19; DESCRIPTION Imports: CMplot) — its README
renders PIP and WPPA Manhattan plots from fit results (README.md:215-227).
This module rebuilds that capability on matplotlib against this framework's
``BlrMod`` results, plus the MCMC-diagnostic plots (trace / density) that a
sampler front-end needs.

All functions return ``(fig, axes)`` and accept an existing ``ax`` so they
compose into user figures.  matplotlib is imported lazily so the package
works headless without it.
"""

from __future__ import annotations

import numpy as np

# Categorical slots 1/2 of the validated reference palette (CVD-safe adjacent
# pair) for the conventional two-tone chromosome alternation; neutral inks
# for text/grid so color carries identity only.
_CHROM_COLORS = ("#2a78d6", "#eb6834")
_SERIES = "#2a78d6"
_INK = "#0b0b0b"
_MUTED = "#52514e"
_GRID = "#d9d8d3"


def _plt():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg", "pdf", "svg"):
        try:  # headless safety: fall back to Agg when no display is usable
            import matplotlib.pyplot as plt  # noqa: F401
        except Exception:
            matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style_axis(ax):
    ax.spines[["top", "right"]].set_visible(False)
    ax.spines[["left", "bottom"]].set_color(_MUTED)
    ax.tick_params(colors=_MUTED, labelcolor=_INK)
    ax.grid(True, axis="y", color=_GRID, linewidth=0.6, alpha=0.8)
    ax.set_axisbelow(True)


def _chrom_layout(chrom, pos):
    """Cumulative x coordinate per SNP + per-chromosome tick midpoints.

    Chromosomes are laid out in order of first appearance (matching the map
    file order, as CMplot does), each offset past the previous chromosome's
    max position with a small gap.
    """
    chrom = np.asarray(chrom).astype(str)
    pos = np.asarray(pos, dtype=np.float64)
    labels = list(dict.fromkeys(chrom))
    x = np.empty_like(pos)
    ticks, offset = [], 0.0
    gap = 0.01 * float(pos.max() - pos.min() + 1.0) * max(len(labels) - 1, 1)
    spans = []
    for c in labels:
        sel = chrom == c
        p = pos[sel]
        x[sel] = p - p.min() + offset
        width = p.max() - p.min()
        ticks.append(offset + width / 2.0)
        spans.append((c, sel))
        offset += width + gap
    return x, labels, ticks, spans


def manhattan(chrom, pos, values, *, ylabel="value", threshold=None,
              log10=False, ax=None, title=None, point_size=9.0):
    """Manhattan plot of a per-SNP (or per-window) statistic.

    chrom/pos/values: equal-length arrays (SNP order).  ``log10=True``
    plots -log10(values) — the GWAS convention for p-values.  ``threshold``
    draws a dashed significance line (in the plotted units).
    """
    plt = _plt()
    values = np.asarray(values, dtype=np.float64)
    if log10:
        values = -np.log10(np.clip(values, 1e-300, None))
    x, labels, ticks, spans = _chrom_layout(chrom, pos)
    fig, ax = (ax.figure, ax) if ax is not None else plt.subplots(figsize=(9, 3.2))
    for i, (c, sel) in enumerate(spans):
        ax.scatter(x[sel], values[sel], s=point_size,
                   color=_CHROM_COLORS[i % 2], linewidths=0, rasterized=True)
    if threshold is not None:
        ax.axhline(threshold, color=_MUTED, linestyle="--", linewidth=1.0)
    ax.set_xticks(ticks, labels)
    ax.set_xlabel("Chromosome", color=_INK)
    ax.set_ylabel(("-log10(" + ylabel + ")") if log10 else ylabel, color=_INK)
    if title:
        ax.set_title(title, color=_INK, loc="left")
    ax.margins(x=0.01)
    _style_axis(ax)
    ax.grid(False, axis="x")
    fig.tight_layout()
    return fig, ax


def manhattan_pip(fit, map, *, threshold=None, ax=None):
    """Per-SNP posterior inclusion probability Manhattan from a fit.

    ``map``: dict with "Chr"/"Pos" columns or array with chr/pos in columns
    1/2 (same convention as the ibrm ``map`` argument).
    """
    if fit.pip is None:
        raise ValueError("fit has no PIP (run a GWAS-enabled method with a map)")
    chrom = np.asarray(map["Chr"] if isinstance(map, dict) else map[:, 1])
    pos = np.asarray(map["Pos"] if isinstance(map, dict) else map[:, 2], dtype=np.float64)
    return manhattan(chrom, pos, fit.pip, ylabel="PIP", threshold=threshold,
                     ax=ax, title=f"Posterior inclusion probability [{fit.method}]")


def manhattan_wppa(fit, *, threshold=0.95, ax=None):
    """Per-window WPPA Manhattan from a fit's gwas table (window midpoints)."""
    if fit.gwas is None:
        raise ValueError("fit has no gwas window table (pass map/windsize to the fit)")
    g = fit.gwas
    mid = (np.asarray(g["Start"], dtype=np.float64)
           + np.asarray(g["End"], dtype=np.float64)) / 2.0
    return manhattan(np.asarray(g["Chr"]), mid, np.asarray(g["WPPA"]),
                     ylabel="WPPA", threshold=threshold, ax=ax,
                     title=f"Window posterior probability of association [{fit.method}]",
                     point_size=16.0)


def qqplot(pvalues, *, ax=None, title="QQ plot"):
    """GWAS quantile-quantile plot: observed vs expected -log10(p)."""
    plt = _plt()
    p = np.sort(np.asarray(pvalues, dtype=np.float64))
    p = p[np.isfinite(p)]
    n = len(p)
    if n == 0:
        raise ValueError("no finite p-values")
    exp = -np.log10((np.arange(1, n + 1) - 0.5) / n)
    obs = -np.log10(np.clip(p, 1e-300, None))
    fig, ax = (ax.figure, ax) if ax is not None else plt.subplots(figsize=(3.6, 3.6))
    lim = max(exp.max(), obs.max()) * 1.05
    ax.plot([0, lim], [0, lim], color=_MUTED, linewidth=1.0, linestyle="--")
    ax.scatter(exp, obs, s=9.0, color=_SERIES, linewidths=0, rasterized=True)
    ax.set_xlabel("Expected -log10(p)", color=_INK)
    ax.set_ylabel("Observed -log10(p)", color=_INK)
    ax.set_xlim(0, lim)
    ax.set_ylim(0, lim)
    ax.set_title(title, color=_INK, loc="left")
    _style_axis(ax)
    fig.tight_layout()
    return fig, ax


_DEFAULT_PARAMS = ("Vg", "Ve", "h2")


def _scalar_traces(fit, params):
    s = fit.MCMCsamples
    out = {}
    for p in params:
        if p not in s:
            raise KeyError(f"no MCMC samples for {p!r}; available: {sorted(s)}")
        v = np.asarray(s[p], dtype=np.float64)
        if v.ndim == 1:
            out[p] = v
        else:  # vector parameter: one trace per component
            for i in range(v.shape[1]):
                out[f"{p}[{i + 1}]"] = v[:, i]
    return out


def trace(fit, params=_DEFAULT_PARAMS, *, axes=None):
    """Thinned-chain trace plots, one panel per scalar parameter.

    Vector parameters (pi, beta, Vr, alpha) expand to one panel per
    component.  The x axis is the thinned record index.
    """
    plt = _plt()
    tr = _scalar_traces(fit, params)
    k = len(tr)
    if axes is None:
        fig, axes = plt.subplots(k, 1, figsize=(7, 1.6 * k), sharex=True, squeeze=False)
        axes = axes[:, 0]
    else:
        fig = axes[0].figure
    for ax, (name, v) in zip(axes, tr.items()):
        ax.plot(np.arange(len(v)), v, color=_SERIES, linewidth=1.2)
        ax.set_ylabel(name, color=_INK)
        _style_axis(ax)
    axes[-1].set_xlabel("thinned record", color=_INK)
    fig.tight_layout()
    return fig, axes


def density(fit, params=_DEFAULT_PARAMS, *, bins=40, axes=None):
    """Posterior density (histogram) panels with the posterior mean marked."""
    plt = _plt()
    tr = _scalar_traces(fit, params)
    k = len(tr)
    if axes is None:
        fig, axes = plt.subplots(1, k, figsize=(2.6 * k, 2.4), squeeze=False)
        axes = axes[0]
    else:
        fig = axes[0].figure
    for ax, (name, v) in zip(axes, tr.items()):
        ax.hist(v, bins=bins, density=True, color=_SERIES, edgecolor="none")
        ax.axvline(v.mean(), color=_INK, linewidth=1.0, linestyle="--")
        ax.set_xlabel(name, color=_INK)
        _style_axis(ax)
    axes[0].set_ylabel("density", color=_INK)
    fig.tight_layout()
    return fig, axes
