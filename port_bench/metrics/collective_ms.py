"""collective_ms (ms): device time an iteration of the collectives'
kernels, the union of their intervals, in rank 0's traced stretch.

The port's collectives (hibayes_tpu_torch/parallel/distributed.py, each
call a ``parallel.*`` span) are its one caller of torch.distributed, so the
NCCL kernels of the stretch are those launched inside those spans; the
trace as the harness keeps it holds no launch correlation, so they are told
by name.  An NCCL kernel spins until its peer arrives, so this holds the
wait for the slower neighbour too.  None where the stretch's iterations
ran no collective (one card, or a program without the spans)."""

from .. import program_spans
from . import device_intervals, union_s

NCCL = r"(?i)nccl"


def read(ctx):
    its = program_spans.iterations(ctx)
    if its is None or not any("parallel.bytes" in c for _, _, c in its):
        return None
    return 1e3 * union_s(device_intervals(ctx, [NCCL], kernels_only=True)) / ctx["iters"]
