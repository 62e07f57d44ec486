"""`BlrMod` results object: posterior summaries + MCMC samples.

Python counterpart of the reference's S3 ``blrMod`` class and its
``summary``/``print`` methods (reference: R/blrMod.r:1-105).  Sample arrays
are stored records-first (axis 0 = thinned MCMC record).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _mean_sd(x, axis=0):
    return np.mean(x, axis=axis), np.std(x, axis=axis, ddof=1)


@dataclass
class BlrMod:
    call: str
    model_desc: str
    method: str
    mu: float = 0.0
    pi: np.ndarray | None = None
    beta: np.ndarray | None = None
    beta_names: list = field(default_factory=list)
    r: dict | None = None            # {"Levels": ..., "Estimation": ...}
    r_names: list = field(default_factory=list)
    r_nlevels: tuple = ()            # level count per random factor
    Vr: np.ndarray | None = None
    Vg: float = 0.0
    Ve: float = 0.0
    h2: float = 0.0
    alpha: np.ndarray | None = None
    g: dict | None = None            # {"id": ..., "gebv": ...}
    e: dict | None = None            # {"id": ..., "e": ...}
    pip: np.ndarray | None = None
    gwas: dict | None = None         # window info + WPPA
    Veps: float | None = None
    J: float | None = None
    epsilon: dict | None = None
    Va: float | None = None
    Vb: float | None = None
    rhat: dict | None = None  # multi-chain Gelman-Rubin diagnostics
    chain_seconds: float | None = None  # wall time of the MCMC loop
    setup_seconds: dict | None = None   # ssbrm: pedigree / imputation / prepare
    guard: np.ndarray | None = None     # sbrm SBayesS guard, per chain: rejected, all 8 failed
    MCMCsamples: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    def summary(self) -> "BlrModSummary":
        s = self.MCMCsamples
        res = BlrModSummary(call=self.call, model_desc=self.model_desc)

        # fixed-effect coefficient table (reference R/blrMod.r:11-26)
        rows, est, sd = ["(Intercept)"], [self.mu], [float(np.std(s["mu"], ddof=1))]
        if self.J is not None and "J" in s:
            rows.append("J")
            est.append(self.J)
            sd.append(float(np.std(s["J"], ddof=1)))
        if self.beta is not None and len(self.beta):
            for i, nm in enumerate(
                self.beta_names or [f"b{i+1}" for i in range(len(self.beta))]
            ):
                rows.append(nm)
                est.append(float(self.beta[i]))
                sd.append(float(np.std(s["beta"][:, i], ddof=1)))
        res.beta = {"names": rows, "Estimate": np.array(est), "SD": np.array(sd)}

        # environmental variances + residual (reference R/blrMod.r:28-40)
        names, var_, vsd = [], [], []
        if self.Vr is not None and len(self.Vr):
            for i, nm in enumerate(self.r_names):
                names.append(nm)
                var_.append(float(self.Vr[i]))
                vsd.append(float(np.std(s["Vr"][:, i], ddof=1)))
        names.append("Residual")
        var_.append(self.Ve)
        vsd.append(float(np.std(s["Ve"], ddof=1)))
        res.VER = {"names": names, "Variance": np.array(var_), "SD": np.array(vsd)}

        # genetic table (reference R/blrMod.r:42-54)
        gn = ["Vg", "h2"]
        ge = [self.Vg, self.h2]
        gs = [float(np.std(s["Vg"], ddof=1)), float(np.std(s["h2"], ddof=1))]
        if self.Veps is not None and "Veps" in s:
            gn.append("Veps")
            ge.append(self.Veps)
            gs.append(float(np.std(s["Veps"], ddof=1)))
        if self.pi is not None:
            for i in range(len(self.pi)):
                gn.append(f"pi{i+1}")
                ge.append(float(self.pi[i]))
                gs.append(float(np.std(s["pi"][:, i], ddof=1)))
        res.VGR = {"names": gn, "Estimate": np.array(ge), "SD": np.array(gs)}

        if self.alpha is not None:
            res.alpha = {
                "Effect": np.asarray(self.alpha),
                "SD": np.std(s["alpha"], axis=0, ddof=1),
            }
        if self.g is not None and "g" in s:
            res.g = dict(self.g)
            res.g["SD"] = np.std(s["g"], axis=1, ddof=1)
        if self.e is not None:
            res.e = self.e
        res.n_obs = len(self.e["id"]) if self.e is not None else 0
        res.groups = list(zip(self.r_names, self.r_nlevels))
        res.n_markers = len(self.alpha) if self.alpha is not None else 0
        res.n_predicted = len(self.g["id"]) if self.g is not None else 0
        return res

    def __repr__(self):
        return (
            f"<BlrMod {self.model_desc}: Vg={self.Vg:.4f} Ve={self.Ve:.4f} "
            f"h2={self.h2:.4f}, {len(self.alpha) if self.alpha is not None else 0} markers>"
        )


@dataclass
class BlrModSummary:
    call: str
    model_desc: str
    beta: dict | None = None
    VER: dict | None = None
    VGR: dict | None = None
    alpha: dict | None = None
    g: dict | None = None
    e: dict | None = None
    n_obs: int = 0
    groups: list = field(default_factory=list)
    n_markers: int = 0
    n_predicted: int = 0

    def __str__(self):
        lines = [self.model_desc, f"Formula: {self.call}", ""]
        if self.e is not None:
            ev = np.asarray(self.e["e"], dtype=np.float64)
            ev = ev[~np.isnan(ev)]
            q = np.percentile(ev, [0, 25, 50, 75, 100])
            lines += [
                "Residuals ($e):",
                "   Min     1Q Median     3Q    Max",
                " ".join(f"{v:6.3f}" for v in q),
                "",
            ]
        if self.beta:
            lines.append("Fixed effects ($beta):")
            lines.append(f"{'':<14}{'Estimate':>10}{'SD':>10}")
            for nm, e_, s_ in zip(self.beta["names"], self.beta["Estimate"], self.beta["SD"]):
                lines.append(f"{nm:<14}{e_:>10.4f}{s_:>10.4f}")
            lines.append("")
        if self.VER:
            lines.append("Environmental random effects ($VER, $r):")
            lines.append(f"{'':<14}{'Variance':>10}{'SD':>10}")
            for nm, e_, s_ in zip(self.VER["names"], self.VER["Variance"], self.VER["SD"]):
                lines.append(f"{nm:<14}{e_:>10.4f}{s_:>10.4f}")
            if self.n_obs:
                # reference: "Number of obs: 500, group: loc, 50; dam, 150"
                # (R/blrMod.r:87-94)
                line = f"Number of obs: {self.n_obs}"
                if self.groups:
                    line += ", group: " + "; ".join(
                        f"{nm}, {nl}" for nm, nl in self.groups
                    )
                lines.append(line)
            lines.append("")
        if self.VGR:
            lines.append("Genetic random effects ($VGR, $g):")
            lines.append(f"{'':<14}{'Estimate':>10}{'SD':>10}")
            for nm, e_, s_ in zip(self.VGR["names"], self.VGR["Estimate"], self.VGR["SD"]):
                lines.append(f"{nm:<14}{e_:>10.4f}{s_:>10.4f}")
            # reference: "Number of markers: 1000 , predicted individuals: 1500"
            # (R/blrMod.r:98-99)
            lines.append(
                f"Number of markers: {self.n_markers} , "
                f"predicted individuals: {self.n_predicted}"
            )
            lines.append("")
        if self.alpha:
            a = self.alpha["Effect"]
            lines.append(f"Marker effects ($alpha): n={len(a)}")
            q = np.percentile(a, [0, 25, 50, 75, 100])
            lines.append("   Min     1Q Median     3Q    Max")
            lines.append(" ".join(f"{v:7.4f}" for v in q))
        return "\n".join(lines)
