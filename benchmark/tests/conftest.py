"""The benchmark's CPU tests: run from the repository root with
`python -m pytest benchmark/tests -q`."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
