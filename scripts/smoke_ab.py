#!/usr/bin/env python3
"""Time chip_smoke.py of several checkouts, in turn, phase by phase, on one GPU.

    python3 scripts/smoke_ab.py [--timeout S] [--log-dir D] LABEL=ROOT [...]

Each ROOT is the root of a checkout of this repository (for instance the
parent commit and the change unpacked with ``git archive`` into
git-ignored directories).  Each checkout's ``python3 chip_smoke.py``
runs from its root, one after another in the order given.  Per run it
keeps the seconds at which each of chip_smoke's phase lines came and
the span each line closes, the dry-run's background ``--all`` seconds,
and the CPU seconds of chip_smoke and the processes it waited for.

Prints the card's name and power limit, then one JSON line per run, and
writes each run's output, every line prefixed by its second, to
``LOG_DIR/smoke_ab_<n>_<label>.log`` (``--log-dir``, by default
``build/smoke_ab``).  Exits non-zero when a run did.  Needs a GPU;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path


def one(n: int, label: str, root: str, timeout: float, out: Path) -> dict:
    """chip_smoke.py of the checkout at ``root``, timed by phase."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    err = []
    reader = threading.Thread(target=lambda: err.extend(proc.stderr),
                              daemon=True)
    reader.start()
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    lines = [(time.perf_counter() - t0, ln.rstrip("\n"))
             for ln in proc.stdout]
    _, status, usage = os.wait4(proc.pid, 0)
    timer.cancel()
    seconds = time.perf_counter() - t0
    reader.join()
    rc = proc.returncode = os.waitstatus_to_exitcode(status)
    log = out / f"smoke_ab_{n}_{label}.log"
    log.write_text("".join(f"{t:9.3f} {ln}\n" for t, ln in lines)
                   + "--- stderr\n" + "".join(err))
    phases, start, dryrun_all = {}, 0.0, None
    for t, ln in lines:
        try:
            rec = json.loads(ln)
        except ValueError:
            continue
        if not isinstance(rec, dict) or "phase" not in rec:
            continue
        phases[rec["phase"]] = {"end_s": t, "span_s": t - start}
        if rec["phase"] == "dryrun":
            dryrun_all = rec.get("all", {}).get("seconds")
        start = t
    last = lines[-1][1] if lines else ""
    return {"label": label, "root": str(Path(root).resolve()), "rc": rc,
            "seconds": seconds, "last_line": last[:200],
            "dryrun_all_s": dryrun_all,
            "cpu_s": usage.ru_utime + usage.ru_stime,
            "cores": os.cpu_count(), "phases": phases, "log": str(log)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=1300.0,
                    help="seconds one chip_smoke run may take")
    ap.add_argument("--log-dir", default="build/smoke_ab",
                    help="where each run's stamped output is written")
    ap.add_argument("runs", nargs="+", metavar="LABEL=ROOT")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out = Path(args.log_dir)
    out.mkdir(parents=True, exist_ok=True)
    worst = 0
    for n, spec in enumerate(args.runs):
        label, root = spec.split("=", 1)
        res = one(n, label, root, args.timeout, out)
        print(json.dumps(res), flush=True)
        worst = worst or res["rc"]
    return 1 if worst else 0


if __name__ == "__main__":
    sys.exit(main())
