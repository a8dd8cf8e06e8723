"""fslint — static analysis for the FastSwitch port's torch hot path.

Counterpart of ``repro/analysis/``.  The engine's performance contract
lives in a handful of disciplines that are invisible to generic linters:
a tensor a CUDA graph was captured over must keep its address (written
in place, never rebound), every capture-keyed or shape-keyed function
reachable from the serving hot path must bucket its shape-determining
arguments to pow2 (O(log) graphs and kernel variants), host
synchronisation is only allowed at the documented staged-copy points,
swap worker threads must never write the pool (the swap-plane residency
contract), and copy futures must never be awaited while holding the pool
lock (swap_manager's deadlock contract).

``python -m repro_torch.analysis [paths]`` runs the rule set over a
source tree (``src/repro_torch`` by default); ``rules.py`` has the
catalog, the reference's DESIGN.md §8 its policy.

The package is stdlib-only on purpose: it imports neither torch nor
jax nor the runtime, so the gate costs seconds and runs anywhere.
"""
from repro_torch.analysis.core import Config, Finding  # noqa: F401
from repro_torch.analysis.driver import jit_budget, run_analysis  # noqa: F401
