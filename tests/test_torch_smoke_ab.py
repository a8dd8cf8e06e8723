"""scripts/smoke_ab.py, which times chip_smoke.py of several checkouts
phase by phase, on a stand-in checkout whose chip_smoke.py prints three
phase lines (CPU; no GPU, no repro_torch)."""
import os
import sys
import textwrap

import pytest

from torch_threads import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import smoke_ab  # noqa: E402

FAKE = textwrap.dedent("""\
    import json, sys, time
    for name in ("device", "build", "dryrun"):
        time.sleep(0.8)
        extra = {"all": {"seconds": 12.5}} if name == "dryrun" else {}
        print(json.dumps({"phase": name, **extra}), flush=True)
    print("to stderr", file=sys.stderr)
    print(json.dumps({"ok": True}))
    sys.exit(EXIT)
""")


@pytest.mark.parametrize("code", [0, 3])
def test_phases_timed_and_exit_code_kept(tmp_path, code):
    root = tmp_path / "checkout"
    root.mkdir()
    (root / "chip_smoke.py").write_text(FAKE.replace("EXIT", str(code)))
    res = smoke_ab.one(0, "change", str(root), 60.0, tmp_path)
    assert res["rc"] == code
    assert list(res["phases"]) == ["device", "build", "dryrun"]
    ends = [p["end_s"] for p in res["phases"].values()]
    assert ends == sorted(ends) and 2.4 <= ends[-1] <= res["seconds"]
    assert sum(p["span_s"] for p in res["phases"].values()) == \
        pytest.approx(ends[-1])
    assert res["dryrun_all_s"] == 12.5
    assert res["last_line"] == '{"ok": true}'
    assert res["cpu_s"] > 0
    log = (tmp_path / "smoke_ab_0_change.log").read_text()
    assert '"phase": "build"' in log and "to stderr" in log


def test_a_run_past_its_time_limit_is_killed(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    (root / "chip_smoke.py").write_text("import time\ntime.sleep(60)\n")
    res = smoke_ab.one(1, "stuck", str(root), 1.0, tmp_path)
    assert res["rc"] != 0 and res["seconds"] < 30
    assert res["phases"] == {} and res["dryrun_all_s"] is None
