#!/usr/bin/env python3
"""Accuracy of a float32 ``eigh`` of a GRM on the card, against float64.

    python3 scripts/eigh_accuracy.py        # from the repository root, on a CUDA machine

For a random int8 cohort's GRM + 0.2 I at a few sizes, prints the largest
eigenvalue error (relative to the largest eigenvalue) of: PyTorch's float32
``eigh`` on the card (cuSOLVER: its Jacobi solver for 32-512 rows, divide and
conquer above), the same on the CPU, and ``make_grm(eigen=True)`` on the
card (which solves float32 GRMs of up to 512 rows in float64), each against
a float64 ``eigh`` of the same matrix, with the card's name and power limit.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from hibayes_tpu_torch.math.grm import make_grm  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("eigh_accuracy: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    rng = np.random.default_rng(13)
    for n, m in ((333, 2050), (2000, 8000)):
        M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
        G = make_grm(M, device="cuda") + 0.2 * torch.eye(n, device="cuda")
        ref = torch.linalg.eigvalsh(G.double())
        scale = float(ref.abs().max())
        err = lambda v: float((v.double().to(ref.device) - ref).abs().max()) / scale
        card = torch.linalg.eigvalsh(G)
        cpu = torch.linalg.eigvalsh(G.cpu())
        grm = make_grm(M, lambda_=0.2, eigen=True, device="cuda")[0]
        # make_grm rebuilds G from M: compare with its own float64 eigh
        G2 = make_grm(M, device="cuda") + 0.2 * torch.eye(n, device="cuda")
        ref2 = torch.linalg.eigvalsh(G2.double())
        grm_err = float((grm.double() - ref2).abs().max()) / float(ref2.abs().max())
        print(f"n={n}: float32 eigh on the card {err(card):.3g}, on the CPU {err(cpu):.3g}, "
              f"make_grm on the card {grm_err:.3g} (relative to the largest eigenvalue; "
              f"{smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
