"""The port's launcher, ``python -m repro_torch.launch.serve``, against the
reference's ``repro.launch.serve`` (CPU, in process).

  * sim mode (replay with both policies, the online smoke, the chaos
    smoke, drain): the ``--out`` results, the event logs and the printed
    lines are equal, all but ``callstack_wall_s``, which is real wall time;
  * real mode on the CPU (``--real --device cpu --online --smoke``, and
    the same with ``--prefix-cache``): the reduced model's run passes
    ``validate_event_log`` and gives the reference's modelled metrics and
    event log (the simulated clock does not depend on the weights);
  * ``--serve --router 2 --real --device cpu`` answers a loopback client
    and stops cleanly on an interrupt;
  * ``--device cuda`` without a GPU exits non-zero with a message naming
    it.

Real-mode runs compared exactly hold their swap tasks to the simulated
clock (``swaps_follow_the_clock``): a swap-out's copy runs on a worker
thread, and a task the clock has passed but whose copy is still running
would otherwise stay in flight for one more poll, so ``n_conflicts`` and
``n_syncs`` (and what follows from them) would depend on how fast the
threads ran.  Both packages are held so, the same way.
"""
import json
import os
import re
import sys

import pytest
import torch

from repro.core import swap_manager as jax_swap_manager
from repro.launch import serve as jax_serve
from repro_torch.core import swap_manager as torch_swap_manager
from repro_torch.launch import serve

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

WALL = re.compile(r'"callstack_wall_s": [0-9.e+-]+')

SIM_RUNS = {
    "replay": ["--policy", "vllm", "--policy", "fastswitch",
               "--conversations", "20"],
    "online_smoke": ["--online", "--smoke"],
    "chaos_smoke": ["--online", "--chaos", "--smoke"],
    "drain": ["--online", "--drain", "5", "--conversations", "20"],
}


@pytest.fixture
def swaps_follow_the_clock():
    """``chip_smoke.swaps_follow_the_clock`` over both packages'
    ``SwapTask``: a task the simulated clock has passed waits for its
    copy before it reports complete, so completions follow the simulated
    clock alone, while the copies still run on the worker threads."""
    with chip_smoke.swaps_follow_the_clock(jax_swap_manager,
                                           torch_swap_manager) as held:
        yield held


def _launch(module, argv, tmp_path, tag, capsys, monkeypatch, events=True):
    """Run ``module.main()`` with ``argv`` plus --out (and --events) under
    ``tmp_path``; returns (results without callstack_wall_s, event log
    text, printed lines with callstack_wall_s masked)."""
    out = tmp_path / f"{tag}.json"
    ev = tmp_path / f"{tag}.jsonl"
    args = [*argv, "--out", str(out)] + (["--events", str(ev)]
                                         if events else [])
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    capsys.readouterr()
    module.main()
    printed = [WALL.sub('"callstack_wall_s": -', line).replace(
        str(ev), "<events>")
        for line in capsys.readouterr().out.splitlines()]
    results = json.loads(out.read_text())
    for r in [results, *[v for v in results.values() if isinstance(v, dict)]]:
        r.pop("callstack_wall_s", None)
    return results, ev.read_text() if events else None, printed


@pytest.mark.parametrize("run", sorted(SIM_RUNS))
def test_sim_launcher_matches_the_reference(run, tmp_path, capsys,
                                            monkeypatch):
    argv = SIM_RUNS[run]
    events = run != "replay"      # the replay writes no event log
    want = _launch(jax_serve, argv, tmp_path, "ref", capsys, monkeypatch,
                   events)
    got = _launch(serve, argv, tmp_path, "port", capsys, monkeypatch,
                  events)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    if events:
        assert serve.validate_event_log(str(tmp_path / "port.jsonl")) > 0


def _real_cpu_smoke(argv, tmp_path, capsys, monkeypatch):
    """The real online smoke with ``argv`` through both launchers (the
    port's on the CPU): the port's results (less its own keys) and event
    log equal the reference's.  Returns the port's results."""
    want, want_ev, _ = _launch(jax_serve, argv, tmp_path, "ref", capsys,
                               monkeypatch)
    got, got_ev, printed = _launch(serve, [*argv, "--device", "cpu"],
                                   tmp_path, "port", capsys, monkeypatch)
    n = serve.validate_event_log(str(tmp_path / "port.jsonl"))
    assert n == jax_serve.validate_event_log(str(tmp_path / "port.jsonl"))
    assert any(line.startswith("online smoke OK") for line in printed)
    # the plain versions run on the CPU: no hand-written kernel launches
    assert got.pop("kernel_launches") == {"paged_attention": 0,
                                          "block_gather_runs": 0,
                                          "block_scatter_runs": 0}
    histories = got.pop("token_histories")
    assert histories and all(histories.values())
    assert got == want
    assert got_ev == want_ev
    return got


def test_real_cpu_online_smoke(tmp_path, capsys, monkeypatch,
                               swaps_follow_the_clock):
    _real_cpu_smoke(["--online", "--smoke", "--real"], tmp_path, capsys,
                    monkeypatch)


def _serves_the_frontend(tmp_path, capsys, monkeypatch):
    """``--serve --router 2`` on two real replicas of the reduced model:
    one session streams its tokens and finishes by length; an interrupt
    stops the server with exit code 0 (a client still connected) and
    leaves a well-formed event log on the replica that served it."""
    prefix = str(tmp_path / "fe")
    run = chip_smoke.serve_one_session(
        ["--router", "2", "--real", "--device", "cpu", "--stream",
         "--events", prefix], list(range(3, 40)))
    assert run["returncode"] == 0, run["stderr"]
    assert run["stdout"][0].startswith("frontend: 2 real replica(s) on ")
    assert "frontend: interrupted, shutting down" in run["stdout"]
    kinds = [e["event"] for e in run["events"]]
    assert kinds[0] == "accepted" and kinds[-1] == "finish"
    tokens = [t for e in run["events"] if e["event"] == "token"
              for t in e["token_ids"]]
    assert len(tokens) == 4 and run["events"][-1]["reason"] == "length"
    logs = [serve.validate_event_log(f"{prefix}_r{i}.jsonl")
            for i in range(2)
            if os.path.getsize(f"{prefix}_r{i}.jsonl")]
    assert len(logs) == 1 and logs[0] > 0


def _serves_the_prefix_cache(tmp_path, capsys, monkeypatch):
    """``--prefix-cache --online --smoke`` (real mode, the reduced model on
    the CPU) gives the reference's results, ``prefix`` stats line and
    event log: every conversation after the first hits the 49-token
    system prompt, with the C1/C2 sanitizer on every step."""
    got = _real_cpu_smoke(["--prefix-cache", "--online", "--smoke"],
                          tmp_path, capsys, monkeypatch)
    assert got["prefix"]["hits"] > 0 and got["prefix_tokens_saved"] > 0
    assert got["invariant_checks"] > 0


def _refuses_cuda_without_gpu(tmp_path, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda serves")
    monkeypatch.setattr(sys, "argv", ["serve", "--real", "--device", "cuda",
                                      "--conversations", "2"])
    with pytest.raises(SystemExit) as exit_:
        serve.main()
    assert exit_.value.code not in (0, None)
    assert "torch.cuda.is_available" in str(exit_.value.code)


@pytest.mark.parametrize("case", [_serves_the_frontend,
                                  _serves_the_prefix_cache,
                                  _refuses_cuda_without_gpu],
                         ids=["serve", "prefix_cache", "cuda_without_gpu"])
def test_launcher_refuses_what_the_port_does_not_serve(
        case, tmp_path, capsys, monkeypatch, swaps_follow_the_clock):
    """The modes the port's launcher once refused.  It now refuses only
    ``--device cuda`` without a GPU; the ``serve`` and ``prefix_cache``
    cases, refusals before, now run those modes and hold them to what
    they serve."""
    case(tmp_path, capsys, monkeypatch)
