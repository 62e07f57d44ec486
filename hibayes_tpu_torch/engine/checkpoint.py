"""Chain checkpoint / resume.

Port of hibayes_tpu/engine/checkpoint.py.  A chain's state is O(n + m) and
every random number of iteration ``it`` comes from streams keyed by (seed,
chain, iteration, stream id) (engine/rng.py), so a snapshot of the state
and the records collected so far resumes bit for bit: the restarted chain
draws exactly what the uninterrupted one would.  No generator state is
saved.

The files are the JAX module's: ``<path>.npz`` holds ``leaf_<i>`` for the
state's leaves and ``sample_<key>`` for the records, written to
``<path>.tmp.npz`` and renamed into place; ``<path>.meta.json`` holds
``n_leaves``, ``sample_keys`` and ``it``.  The leaves are the fields of the
port's state (``ChainState``, ``SChainState``) in their declared order,
tuples flattened; a state may travel with other tensors a chain carries
(the summary guard's ``tally``), given as ``(state, {name: tensor})``.
``it`` is leaf 0, an int64 scalar (one per batch: its chains share it).

Unlike the JAX loader, :func:`load_checkpoint` checks every leaf against
the template (count, shape, dtype) and raises a ValueError naming the
field on a mismatch, so a checkpoint of another spec, or one of the JAX
package's (whose ``it`` is int32, one per chain), never loads silently.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _named_leaves(obj, name=""):
    """(name, leaf) pairs of a state: a named tuple's fields in order, a
    tuple's items (a top-level tuple adds no name), a dict's items."""
    if hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from _named_leaves(getattr(obj, f), f"{name}.{f}" if name else f)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _named_leaves(v, f"{name}.{k}" if name else k)
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            yield from _named_leaves(v, f"{name}[{i}]" if name else "")
    else:
        yield name, obj


def _rebuild(template, leaves):
    """The template's structure with its leaves taken in order from the
    iterator ``leaves``."""
    if hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves) for k, v in template.items()}
    if isinstance(template, tuple):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, dtype=np.int64)   # the iteration counter


def save_checkpoint(path: str, state, samples_so_far: dict):
    """Write the state's leaves and the records so far to <path>.npz
    (atomic rename) and <path>.meta.json."""
    leaves = [_to_numpy(v) for _, v in _named_leaves(state)]
    payload = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    for k, v in samples_so_far.items():
        payload[f"sample_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path + ".npz")
    with open(path + ".meta.json", "w") as f:
        json.dump({"n_leaves": len(leaves),
                   "sample_keys": sorted(samples_so_far.keys()),
                   "it": int(leaves[0].reshape(-1)[0])}, f)


def load_checkpoint(path: str, template_state):
    """Rebuild (state, samples_so_far) from <path>.npz on the template's
    devices and dtypes.  Returns None if no checkpoint exists; raises a
    ValueError naming the field whose count, shape or dtype differs from
    the template's."""
    if not os.path.exists(path + ".npz"):
        return None
    named = list(_named_leaves(template_state))
    with np.load(path + ".npz") as data:
        n_file = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_file != len(named):
            raise ValueError(
                f"checkpoint {path}.npz holds {n_file} state leaves, this chain's "
                f"state has {len(named)} (fields {[n for n, _ in named]}): it was "
                "written for another spec or by another package")
        leaves = []
        for i, (name, tl) in enumerate(named):
            arr = data[f"leaf_{i}"]
            if isinstance(tl, torch.Tensor):
                want_shape = tuple(tl.shape)
                want_dt = torch.empty((), dtype=tl.dtype).numpy().dtype
            else:
                want_shape, want_dt = (), np.dtype(np.int64)
            if arr.shape != want_shape or arr.dtype != want_dt:
                raise ValueError(
                    f"checkpoint {path}.npz: field {name!r} is {arr.dtype}{list(arr.shape)}, "
                    f"this chain's is {want_dt}{list(want_shape)}: it was written for "
                    "another spec or by another package")
            leaves.append(torch.from_numpy(arr.copy()).to(tl.device)
                          if isinstance(tl, torch.Tensor) else int(arr))
        samples = {k[len("sample_"):]: data[k] for k in data.files
                   if k.startswith("sample_")}
    return _rebuild(template_state, iter(leaves)), samples
