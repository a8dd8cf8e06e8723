"""The port's launcher, ``python -m repro_torch.launch.serve``, against the
reference's ``repro.launch.serve`` (CPU, in process).

  * sim mode (replay with both policies, the online smoke, the chaos
    smoke, drain): the ``--out`` results, the event logs and the printed
    lines are equal, all but ``callstack_wall_s``, which is real wall time;
  * real mode on the CPU (``--real --device cpu --online --smoke``): the
    reduced model's run passes ``validate_event_log`` and gives the
    reference's modelled metrics and event log (the simulated clock does
    not depend on the weights);
  * what the port does not serve yet exits non-zero with a message naming
    it: ``--serve`` / ``--router``, ``--prefix-cache``, and ``--device
    cuda`` without a GPU.
"""
import json
import re
import sys

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve

WALL = re.compile(r'"callstack_wall_s": [0-9.e+-]+')

SIM_RUNS = {
    "replay": ["--policy", "vllm", "--policy", "fastswitch",
               "--conversations", "20"],
    "online_smoke": ["--online", "--smoke"],
    "chaos_smoke": ["--online", "--chaos", "--smoke"],
    "drain": ["--online", "--drain", "5", "--conversations", "20"],
}


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


def test_real_cpu_online_smoke(tmp_path, capsys, monkeypatch):
    argv = ["--online", "--smoke", "--real"]
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
    assert got == want
    assert got_ev == want_ev


@pytest.mark.parametrize("argv,names", [
    (["--serve", "--router", "2"], "repro_torch.frontend"),
    (["--prefix-cache", "--online", "--smoke"], "prefix cache"),
    (["--real", "--device", "cuda", "--conversations", "2"],
     "torch.cuda.is_available"),
], ids=["serve", "prefix_cache", "cuda_without_gpu"])
def test_launcher_refuses_what_the_port_does_not_serve(argv, names,
                                                      monkeypatch):
    if "cuda" in argv and torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda serves")
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as exit_:
        serve.main()
    assert exit_.value.code not in (0, None)
    assert names in str(exit_.value.code)
