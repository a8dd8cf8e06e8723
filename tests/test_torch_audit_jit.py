"""``python -m repro_torch.launch.dryrun --audit-jit``: the live counts of
the decode step's CUDA graphs and of the swap, insert and chunk sites'
padded shape keys, held to fslint's static FS002 bounds (the reference's
``run_jit_audit``).

  * the CLI on the CPU exits 0 with its five rows, each within its bound
    and with static degrees;
  * with the pow2 bucketing helpers monkeypatched to identity, a serving
    case over uneven prompt lengths fails the audit (more padded shapes
    at the insert and chunk sites than the bound), where the same case
    with the helpers in place passes;
  * a row whose static degrees are missing fails the audit;
  * the ``*_cache_size()`` counters count distinct keys, not calls.
"""
import json
import os
import subprocess
import sys

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import decode_runner
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# one request per prompt length, pool of 256 one-token blocks: the bound
# is (log2(256) + 2) ** 2 = 121, and 124 distinct lengths need 124
# unbucketed chunk shapes (a one-token block keeps any length aligned)
UNEVEN = dict(prompt_lens=tuple(range(4, 4 + 124)), max_tokens=2,
              num_gpu_blocks=256, block_size=1)


def test_cli_exits_0_with_five_rows_within_bounds():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--audit-jit", "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    (line,) = [ln for ln in r.stdout.splitlines() if "x jit-audit" in ln]
    assert line.startswith("ok   qwen2-1.5b x jit-audit ")
    out = json.loads(line.split(" x jit-audit ", 1)[1])
    assert out["violations"] == []
    assert list(out["functions"]) == list(dryrun.AUDIT_ROWS)
    for row in out["functions"].values():
        assert row["bound"] == 13 ** 2          # 64 blocks of 16 tokens
        assert 0 <= row["live_variants"] <= row["bound"]
    degrees = {k: v["static_degrees"] for k, v in out["functions"].items()}
    assert degrees["kernels.ops._gather_swap"] == 2      # n_slab, run_blocks
    assert degrees["kernels.ops._scatter_swap"] == 1     # run_blocks
    assert out["functions"]["models.paged.paged_decode_step_device"][
        "live_variants"] >= 1


def test_unbucketed_path_fails_the_audit(monkeypatch):
    ok = dryrun.run_jit_audit("qwen2-1.5b", "cpu", **UNEVEN)
    assert ok["status"] == "ok", ok
    assert ok["max_tokens"] == 256 and ok["functions"][
        "models.paged.prefill_kv_chunk"]["bound"] == 121
    ident = lambda n: max(int(n), 1)  # noqa: E731
    monkeypatch.setattr(ops, "_next_pow2", ident)
    monkeypatch.setattr(decode_runner, "next_pow2", ident)
    bad = dryrun.run_jit_audit("qwen2-1.5b", "cpu", **UNEVEN)
    assert bad["status"] == "FAIL"
    rows = bad["functions"]
    for site in ("models.paged.prefill_kv_chunk",
                 "kernels.ops._insert_prefill"):
        assert rows[site]["live_variants"] == len(UNEVEN["prompt_lens"])
        assert rows[site]["live_variants"] > rows[site]["bound"]
        assert rows[site]["live_variants"] > \
            ok["functions"][site]["live_variants"]
        assert any(v.startswith(site) for v in bad["violations"])


def test_missing_static_row_fails_the_audit(monkeypatch):
    """A row FS002 no longer reports (the static pass lost track of the
    function) fails, whatever the live count."""
    from repro_torch.analysis import driver

    def serving(arch, device, **kw):
        return {"status": "ok", "t_total_s": 0.0,
                "decode_graph_variants": 1}

    real = driver.jit_budget

    def budget(*a, **k):
        d = real(*a, **k)
        return {q: v for q, v in d.items()
                if not q.endswith("kernels.ops._scatter_swap")}

    monkeypatch.setattr(driver, "jit_budget", budget)
    monkeypatch.setattr(dryrun, "run_serving_case", serving)
    r = dryrun.run_jit_audit("qwen2-1.5b", "cpu")
    assert r["status"] == "FAIL"
    assert r["violations"] == ["kernels.ops._scatter_swap: no static "
                               "degrees (FS002 lost track of it)"]


def test_cache_sizes_count_distinct_keys_not_calls():
    cfg = get_smoke_config("qwen2-1.5b")
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(0)
    pool = torch.randn((L, 2, 32, 16, Hkv, D), generator=gen).to(
        torch.bfloat16)
    ops.reset_cache_sizes()
    sizes = lambda: (ops.swap_gather_cache_size(),  # noqa: E731
                     ops.swap_scatter_cache_size(),
                     ops.insert_prefill_cache_size(),
                     ops.prefill_chunk_cache_size())
    assert sizes() == (0, 0, 0, 0)
    # runs of 3 and 4 blocks pad to the same slab (4 blocks, runs of 4)
    for runs in ([(1, 3)], [(5, 4)], [(9, 3)]):
        slab, _ = ops.gather_swap_runs(pool, runs)
        ops.scatter_swap_runs(pool, slab, runs)
    assert sizes()[:2] == (1, 1)
    slab, _ = ops.gather_swap_runs(pool, [(1, 3), (10, 2)])
    ops.scatter_swap_runs(pool, slab, [(1, 3), (10, 2)])
    assert sizes()[:2] == (2, 2)
    k = torch.zeros((L, 32, Hkv, D), dtype=torch.bfloat16)
    for blocks in ([3, 4], [7, 8], [9, 10]):
        ops.insert_prefill(pool, k, k, blocks, 16)
    assert sizes()[2] == 1
    ops.insert_prefill(pool, k[:, :16], k[:, :16], [3], 16)
    assert sizes()[2] == 2
    params = T.init_params(cfg, seed=0, device="cpu", serving=True)
    for n in (20, 25, 31):                      # one (32, 32) bucket
        ops.prefill_chunk(params, list(range(1, n + 1)), None, None, 0,
                          cfg=cfg, block_size=16)
    assert sizes()[3] == 1
    ops.prefill_chunk(params, list(range(1, 40)), None, None, 0, cfg=cfg,
                      block_size=16)
    assert sizes() == (2, 2, 2, 2)
    ops.reset_cache_sizes()
    assert sizes() == (0, 0, 0, 0)
