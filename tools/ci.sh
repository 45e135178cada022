#!/bin/bash
# CI entry: fast gate for every change.
#
#   tools/ci.sh          # lint-less fast suite (default gate)
#   tools/ci.sh full     # + slow full scenario x planner matrix
#
# The default suite includes one FULL closed-loop scenario per planner
# family (tests/test_sim.py) plus all kernel/oracle/unit tests; it runs
# on the virtual 8-device CPU mesh (tests/conftest.py) and needs no GPU.
set -euo pipefail
cd "$(dirname "$0")/.."

args=(-q -x)
if command -v nproc >/dev/null && [ "$(nproc)" -ge 4 ]; then
    # sim scenarios isolate their shm namespaces per test (uuid app ids),
    # so the suite is xdist-safe
    args+=(-n 2)
fi

if [ "${1:-}" = "full" ]; then
    export TPL_TPU_SLOW_TESTS=1
fi

exec python3 -m pytest tests/ "${args[@]}"
