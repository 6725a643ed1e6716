"""The benchmark's own tests (``python -m pytest portbench/tests``): they
run on the CPU at small sizes; a test that needs the card carries the
``cuda`` marker and skips where there is none."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
