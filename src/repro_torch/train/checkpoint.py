"""Flat-file checkpoints: a tree of tensors <-> ``.npz`` with path keys.

Counterpart of ``repro/train/checkpoint.py``, with its keys: a dict entry
adds its key, a NamedTuple field (``AdamWState``) ``.`` and its name, a
sequence item its index, all joined by ``/`` -- ``embed/table``,
``layers/attn/wq``, ``.step``, ``.mu/embed/table`` -- so a file either
package writes loads in the other.  ``load_checkpoint`` also loads the
reference's parameter files into the port's tree.
"""
from __future__ import annotations

import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def keyed_leaves(tree, path: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every tensor in ``tree``, keyed as the files are."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from keyed_leaves(v, path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from keyed_leaves(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from keyed_leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(like, data, path: Tuple[str, ...] = ()):
    if isinstance(like, dict):
        return {k: _rebuild(v, data, path + (str(k),))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), data,
                                     path + (f".{f}",))
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, data, path + (str(i),))
                          for i, v in enumerate(like))
    arr = np.array(data["/".join(path)])
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


def save_checkpoint(path: str, tree: Any) -> None:
    """Write every tensor of ``tree`` (fp32, integer, ... : a dtype numpy
    holds) to ``path`` (``np.savez``, which adds ``.npz`` if missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in keyed_leaves(tree)})


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf takes the
    file's array under its key, in ``like``'s leaf's dtype and on its
    device."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return _rebuild(like, data)
