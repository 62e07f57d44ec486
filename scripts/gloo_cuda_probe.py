"""Which collectives each backend runs on CUDA tensors with two ranks.

Spawns two ranks (torch.multiprocessing) that join a gloo group, both on
cuda:0 when the card is alone (NCCL refuses two ranks on one device), or an
NCCL group with a card each where there are two; for each of all_reduce,
broadcast, all_gather and a send/recv pair (batch_isend_irecv), in a
process group of its own, they run it on CUDA tensors and check the
values.  Prints one JSON line per backend:
{"backend": ..., "ranks_on": [...], "ok": {op: true/false}, "error": {op: msg}}.
parallel/distributed.py stages through the host the collectives gloo does
not take (GLOO_HOST_OPS).  Run on a machine with a card:

    python scripts/gloo_cuda_probe.py
"""

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, backend, init, out, only):
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=2, rank=rank)
    ok, err = {}, {}

    def attempt(name, fn):
        try:
            ok[name] = bool(fn())
        except Exception as e:   # the probe records what fails
            ok[name], err[name] = False, f"{type(e).__name__}: {e}"[:300]

    def all_reduce():
        t = torch.full((1000,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize(dev)
        return bool((t == 3.0).all())

    def broadcast():
        t = torch.full((1000,), float(rank + 1), device=dev)
        dist.broadcast(t, src=1)
        torch.cuda.synchronize(dev)
        return bool((t == 2.0).all())

    def all_gather():
        t = torch.full((10,), float(rank), device=dev)
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        torch.cuda.synchronize(dev)
        return bool((torch.cat(parts) == torch.tensor([0.0] * 10 + [1.0] * 10, device=dev)).all())

    def send_recv():
        s = torch.full((10,), float(rank), device=dev)
        r = torch.empty_like(s)
        ops = [dist.P2POp(dist.isend, s, 1 - rank), dist.P2POp(dist.irecv, r, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        torch.cuda.synchronize(dev)
        return bool((r == float(1 - rank)).all())

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather), ("send_recv", send_recv)):
        if name == only:
            attempt(name, fn)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"backend": backend, "ranks_on": [str(dev), f"cuda:{1 % torch.cuda.device_count()}"],
                       "ok": ok, "error": err}, f)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    for backend in backends:
        for op in ("all_reduce", "broadcast", "all_gather", "send_recv"):
            # each collective in a group of its own: a failed one may break the group
            with tempfile.TemporaryDirectory() as tmp:
                init = "file://" + os.path.join(tmp, "rendezvous")
                out = os.path.join(tmp, "out.json")
                try:
                    mp.spawn(_rank, args=(backend, init, out, op), nprocs=2, join=True)
                    print(open(out).read(), flush=True)
                except Exception as e:   # the probe records the failure and goes on
                    print(json.dumps({"backend": backend, "ok": {op: False},
                                      "error": {op: str(e).strip().splitlines()[-1][:300]}}),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
