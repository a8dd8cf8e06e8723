"""Launch counts of the hand-written kernels, eager and under CUDA graphs.

Each wrapper counts its kernel's launches in its ``launches`` attribute
through ``count``.  A launch recorded into a CUDA graph that is being
captured does not run then, so it is not counted there: it goes to the
tally of the enclosing ``capture()`` block, which the graph keeps, and
every replay of the graph adds that tally to the wrappers' counts
(``replayed``).  So a count is the number of times the kernel ran,
whether it was launched alone or as a node of a replayed graph.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Counter, Iterator

import torch

# the tally of the capture in progress in this context, if any
_tally: contextvars.ContextVar = contextvars.ContextVar("launch_tally",
                                                        default=None)


def count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel on the current CUDA stream: into
    ``wrapper.launches``, or into the capture's tally while the stream is
    capturing a graph."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
        return
    tally = _tally.get()
    if tally is None:
        raise RuntimeError(f"{wrapper.__name__}: captured into a CUDA graph "
                           "outside launches.capture(), so the graph's "
                           "replays would go uncounted")
    tally[wrapper] += 1


@contextlib.contextmanager
def capture() -> Iterator[Counter]:
    """Collect the launches recorded while a graph is captured inside the
    block: yields a Counter {wrapper: launches per replay}."""
    tally: Counter = collections.Counter()
    token = _tally.set(tally)
    try:
        yield tally
    finally:
        _tally.reset(token)


def replayed(tally: Counter) -> None:
    """Count one replay of a graph whose capture collected ``tally``."""
    for wrapper, n in tally.items():
        wrapper.launches += n
