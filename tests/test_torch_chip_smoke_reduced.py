"""chip_smoke.py's ``reduced`` phase on the CPU, as ``scripts/
reduced_probe.py --device cpu`` runs it (both runs of each policy on the
CPU, the kernels' plain versions) with ``jax`` blocked, on two of the
five reduced configs; its gate (``reduced_gate``) fails a stream
parting past the CPU run's near-ties and an unequal swap count; the
launcher's ``--real --device cuda --reduced`` without a GPU exits with
the no-GPU message and draws no weights.  One of the files ``tests/test_torch_chip_smoke_*
.py``, split by phase."""
import copy
import json
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("qwen2-1.5b", "olmoe-1b-7b")


@pytest.fixture(scope="module")
def reduced():
    """The phase's line as ``scripts/reduced_probe.py --device cpu``
    emits it, at two of the five archs."""
    code = ("import sys, tempfile, time\n"
            "from pathlib import Path\n"
            "sys.modules['jax'] = None\n"
            f"sys.path[:0] = [{ROOT!r}]\n"
            "import torch\n"
            "import chip_smoke as cs\n"
            "t0 = time.perf_counter()\n"
            "with tempfile.TemporaryDirectory() as tmp:\n"
            "    res = cs.reduced_phase(torch.device('cpu'), Path(tmp),\n"
            f"                           archs={ARCHS!r})\n"
            "cs.emit('reduced', nvidia_smi=None, device='cpu',\n"
            "        probe_seconds=time.perf_counter() - t0, **res)\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = r.stdout.splitlines()[-1]
    assert line.startswith('{"phase": "reduced"')
    return json.loads(line)


def test_reduced_phase_line(reduced):
    """The emitted line: per arch its reduced geometry (head_dim 64) and
    per policy the gate's record, swaps both ways, streams equal (both
    runs on the CPU compute alike), every staged swap checked; the
    launcher's reduced smoke served its tokens."""
    assert set(reduced) == {"phase", "nvidia_smi", "device",
                            "probe_seconds", "archs", "policies",
                            "near_tie", "route_tie", "launcher_smoke",
                            "seconds"}
    assert reduced["device"] == "cpu" and reduced["nvidia_smi"] is None
    assert list(reduced["archs"]) == list(ARCHS)
    assert reduced["policies"] == list(chip_smoke.REDUCED_POLICIES)
    assert reduced["near_tie"] == chip_smoke.NEAR_TIE
    for arch, r in reduced["archs"].items():
        assert (r["head_dim"], r["n_layers"], r["d_model"]) == (64, 2, 256)
        assert r["n_heads"] // r["n_kv_heads"] in (1, 2), arch
        for pol in reduced["policies"]:
            g = r[pol]
            assert set(g) == {"swap_ops", "blocks_moved", "streams_equal",
                              "parting_at", "launches",
                              "moved_kv_blocks_checked", "wall_s"}
            assert min(g["swap_ops"].values()) > 0, (arch, pol)
            assert g["streams_equal"] == 8 and g["parting_at"] == []
            for side in ("card", "cpu"):
                moved = g["moved_kv_blocks_checked"][side]
                assert moved["out_blocks"] > 0 and moved["in_blocks"] > 0
            # the plain versions run on the CPU: no launch to count
            assert set(g["launches"].values()) == {0}
    smoke = reduced["launcher_smoke"]
    assert smoke["argv"][-2:] == ["--device", "cpu"]
    assert smoke["total_tokens"] > 0
    assert smoke["stdout"][-1].startswith("online smoke OK")


def _planted():
    """A CPU run's record, histories and engine gaps as ``reduced_gate``
    takes them, and a card twin equal to it: 3 conversations of 24
    tokens each, every engine call's gaps clear of both near-tie rules."""
    g = torch.Generator().manual_seed(5)
    hists = {c: torch.randint(0, 512, (24,), generator=g).tolist()
             for c in range(3)}
    rec = {"swap_ops": {"out": 9, "in": 7}, "blocks_moved": {"out": 30,
                                                             "in": 21},
           "launches": {"paged_attention": 0, "block_gather_runs": 0,
                        "block_scatter_runs": 0},
           "moved_kv_blocks_checked": {"out_blocks": 30, "in_blocks": 21},
           "wall_s": 0.1}
    gaps = {tuple(h[:p]): (0.5, float("inf"))
            for h in hists.values() for p in range(8, 24)}
    cpu = {"hists": hists, "rec": rec, "on_card": False, "gaps": gaps}
    card = copy.deepcopy(cpu)
    card["gaps"] = None
    return cpu, card


def _part(cpu, card, cid, at, gaps):
    """The card's conversation ``cid`` parts at ``at``; the CPU engine
    call that produced the CPU's token there had ``gaps``."""
    card["hists"][cid][at] = (cpu["hists"][cid][at] + 1) % 512
    cpu["gaps"][tuple(cpu["hists"][cid][:at])] = gaps


def test_reduced_gate_holds_partings_to_the_cpu_runs_near_ties():
    """Equal runs pass; a parting where the CPU's engine call had a
    logit gap under NEAR_TIE passes, as does one at a MoE routing gap
    under ROUTE_TIE; a parting past both fails, and so does one no CPU
    call produced."""
    cpu, card = _planted()
    rec = chip_smoke.reduced_gate(card, cpu)
    assert rec["streams_equal"] == 3 and rec["parting_at"] == []
    _part(cpu, card, 1, 12, (chip_smoke.NEAR_TIE * 0.9, float("inf")))
    _part(cpu, card, 2, 20, (0.3, chip_smoke.ROUTE_TIE * 0.5))
    rec = chip_smoke.reduced_gate(card, cpu)
    assert rec["streams_equal"] == 1
    assert rec["parting_at"] == [[1, 12, chip_smoke.NEAR_TIE * 0.9, None],
                                 [2, 20, 0.3, chip_smoke.ROUTE_TIE * 0.5]]
    _part(cpu, card, 0, 9, (chip_smoke.NEAR_TIE, chip_smoke.ROUTE_TIE))
    with pytest.raises(AssertionError, match="parts from the CPU's at 9"):
        chip_smoke.reduced_gate(card, cpu)
    cpu, card = _planted()
    card["hists"][0][3] += 1                # a position no call produced
    with pytest.raises(AssertionError, match="no CPU engine call"):
        chip_smoke.reduced_gate(card, cpu)


def test_reduced_gate_fails_unequal_swap_counts_and_no_launch():
    cpu, card = _planted()
    card["rec"]["swap_ops"]["in"] += 1
    with pytest.raises(AssertionError, match="swap_ops"):
        chip_smoke.reduced_gate(card, cpu)
    cpu, card = _planted()
    card["rec"]["blocks_moved"]["out"] -= 1
    with pytest.raises(AssertionError, match="blocks_moved"):
        chip_smoke.reduced_gate(card, cpu)
    cpu, card = _planted()
    card["on_card"] = True                  # a card run with no launch
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.reduced_gate(card, cpu)


def test_engine_gaps_record_every_produced_token():
    """A CPU engine run of the reduced olmoe-1b-7b under ``engine_gaps``:
    every generated token of every conversation has its producing call's
    gaps, the routing gap finite (a MoE), the logit gap the top-2 of the
    call's logits (positive)."""
    _, bundle = chip_smoke.reduced_bundles("olmoe-1b-7b", "cpu")
    convs = chip_smoke.conversations(2, (64,), (32,), max_tokens=8)
    sizes = dict(gpu_blocks=12, cpu_blocks=64, max_running=2)
    with chip_smoke.engine_gaps() as gaps:
        eng, _ = chip_smoke.ladder_run(bundle, convs, sizes, "fastswitch")
    for c in convs:
        hist = eng._token_hist_by_conv[c.conv_id]
        for p in chip_smoke.generated_positions(c):
            lg, rg = gaps[tuple(hist[:p])]
            assert lg >= 0 and 0 <= rg < 1
    eng.shutdown()


def test_reduced_bundles_hold_the_same_bits():
    """The card's and the CPU's bundles come from one CPU draw: equal
    leaf for leaf (here both on the CPU), bf16 serving weights."""
    card, cpu = chip_smoke.reduced_bundles("mistral-nemo-12b", "cpu")
    assert card["cfg"].head_dim == 64 and card["cfg"] == cpu["cfg"]
    a = chip_smoke._leaves(card["params"])
    b = chip_smoke._leaves(cpu["params"])
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert any(x.dtype == torch.bfloat16 for x in
               chip_smoke._leaves(cpu["params"]))


def test_launcher_reduced_on_cuda_without_a_gpu_exits(monkeypatch):
    """``--real --device cuda --reduced`` where there is no GPU exits
    non-zero with the no-GPU message before any weight is drawn: no
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda --reduced serves")

    def drawn(*a, **k):
        raise AssertionError("weights drawn: the launcher fell back")
    monkeypatch.setattr(T, "init_params", drawn)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--online", "--smoke", "--real", "--device", "cuda",
        "--reduced", "--arch", "qwen2-1.5b"])
    with pytest.raises(SystemExit) as exit_:
        serve.main()
    assert exit_.value.code not in (0, None)
    assert "torch.cuda.is_available() is false" in str(exit_.value.code)
