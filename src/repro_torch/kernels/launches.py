"""Launch counts of the hand-written kernels, eager and under CUDA graphs.

Each wrapper counts its kernel's launches in its ``launches`` attribute
through ``count``.  A launch recorded into a CUDA graph that is being
captured does not run then, so it is not counted there: it goes to the
tally of the enclosing ``capture()`` block, which the graph keeps, and
every replay of the graph adds that tally to the wrappers' counts
(``replayed``).  So a count is the number of times the kernel ran,
whether it was launched alone or as a node of a replayed graph.

Counts are process-wide sums, safe to make from several threads at once
(the front-end's replicas step on a thread each, and swap workers launch
copies).  A wrapper that names the pool it works on (``count(wrapper,
on=pool)``) is also counted per pool: ``on(wrapper, pool)`` reads the
launches made on one engine's pool (summed over its shards under a
mesh), so each replica's share is known.
``reset`` sets both to 0.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
from typing import Counter, Iterator, Optional

import torch

# the tally of the capture in progress in this context, if any
_tally: contextvars.ContextVar = contextvars.ContextVar("launch_tally",
                                                        default=None)
_lock = threading.Lock()
# (wrapper, storage address of the pool it worked on) -> launches
_on: Counter = collections.Counter()


class Tally(collections.Counter):
    """{wrapper: launches per replay} of one captured graph, and in
    ``on`` the same split by pool: {(wrapper, pool storage): launches}."""

    def __init__(self):
        super().__init__()
        self.on: Counter = collections.Counter()


def refuse_shapes_only(name: str, *tensors) -> None:
    """Raise ``TypeError`` for a meta or fake tensor: a kernel wrapper
    neither launches nor falls back to its plain version on a tensor
    without data (the dry-run's traces reach none)."""
    from torch._subclasses.fake_tensor import FakeTensor
    for t in tensors:
        if isinstance(t, torch.Tensor) and (t.is_meta
                                            or isinstance(t, FakeTensor)):
            raise TypeError(f"{name}: a meta or fake tensor has no data "
                            "for the kernel or its plain version")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def count(wrapper, on: Optional[torch.Tensor] = None) -> None:
    """One launch of ``wrapper``'s kernel on the current CUDA stream: into
    ``wrapper.launches`` (and the count of the pool ``on``, a view of it
    or the pool itself), or into the capture's tally while the stream is
    capturing a graph."""
    key = None if on is None else (wrapper, _storage(on))
    if not torch.cuda.is_current_stream_capturing():
        with _lock:
            wrapper.launches += 1
            if key is not None:
                _on[key] += 1
        return
    tally = _tally.get()
    if tally is None:
        raise RuntimeError(f"{wrapper.__name__}: captured into a CUDA graph "
                           "outside launches.capture(), so the graph's "
                           "replays would go uncounted")
    tally[wrapper] += 1
    if key is not None:
        tally.on[key] += 1


@contextlib.contextmanager
def capture() -> Iterator[Tally]:
    """Collect the launches recorded while a graph is captured inside the
    block (in this thread): yields a ``Tally``."""
    tally = Tally()
    token = _tally.set(tally)
    try:
        yield tally
    finally:
        _tally.reset(token)


def replayed(tally: Counter) -> None:
    """Count one replay of a graph whose capture collected ``tally``."""
    with _lock:
        for wrapper, n in tally.items():
            wrapper.launches += n
        _on.update(getattr(tally, "on", {}))


def on(wrapper, pool) -> int:
    """Launches of ``wrapper``'s kernel counted on ``pool`` (by its
    storage, so any view of the pool names it) since the last ``reset``;
    summed over the shards of a per-shard pool list."""
    pools = pool if isinstance(pool, (list, tuple)) else [pool]
    with _lock:
        return sum(_on[(wrapper, _storage(p))] for p in pools)


def reset(*wrappers) -> None:
    """Set the counts of ``wrappers``, in total and per pool, to 0."""
    with _lock:
        for wrapper in wrappers:
            wrapper.launches = 0
            for key in [k for k in _on if k[0] is wrapper]:
                del _on[key]
