"""The benchmark's own tests (python -m pytest benchmark/tests from the repo
root; the repo's tests/ does not collect them): the harness's modules and
the repo root on the path."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)
