#!/usr/bin/env sh
# Tier-1 verify of the PyTorch/CUDA port in one command, on the CPU (the
# counterpart of scripts/tier1.sh, which verifies the JAX reference):
#   scripts/tier1_torch.sh                # the port's gate, tests, smokes
#   scripts/tier1_torch.sh -k chaos       # extra args forwarded to pytest
#   scripts/tier1_torch.sh -n 6           # ... e.g. xdist workers
# No benches.  Card tests (marker `gpu`) skip here; chip_smoke.py and
# `pytest -m gpu` run on an NVIDIA GPU.
set -e
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
# fslint gate: the port's hot-path static analysis (torch meanings of
# FS001-FS007; stdlib only, imports neither torch nor jax).  Any finding
# that is not suppressed at its site fails the run.
python -m repro_torch.analysis src/repro_torch --format json \
    > "$out/fslint.json" || { cat "$out/fslint.json"; exit 1; }
# the port's CPU tests: parity with the reference on numpy-seeded inputs
# and the reference's weights, the control-plane suites, chip_smoke's
# phases at smoke size
python -m pytest -q tests/test_torch_*.py "$@"
# online serving-API smokes: sim, then real mode on the reduced model on
# the CPU; each event log must be well-formed
python -m repro_torch.launch.serve --online --smoke \
    --events "$out/online_sim.jsonl"
python -m repro_torch.launch.serve --online --smoke --real --device cpu \
    --events "$out/online_real.jsonl"
# chaos smoke: a seeded fault schedule under the sanitizer after every
# step: faults fire, step() never raises, the event log stays well-formed
python -m repro_torch.launch.serve --online --smoke --chaos \
    --events "$out/online_chaos.jsonl"
# prefix-cache smoke (real mode, the reduced model on the CPU): shared
# system-prompt hits under the refcount sanitizer after every step
python -m repro_torch.launch.serve --online --smoke --prefix-cache \
    --device cpu --events "$out/online_prefix.jsonl"
# front-end smoke: the loopback server over two sim replicas, a clean
# drain, every replica's event log validated, no affinity violation
python -m repro_torch.frontend.loadgen --smoke \
    --events-prefix "$out/online_frontend"
