"""Device meshes over torch.distributed (mesh.py) and the collectives and
multi-process helpers the sharded sweeps use (distributed.py)."""
