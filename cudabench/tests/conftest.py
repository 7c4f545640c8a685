"""The benchmark's own tests: run from the repository's root,

    python -m pytest -q cudabench/tests

(the card's with `-m cuda`, which skip without one). The repository's root
goes on the path so that `cudabench` and the port import as packages."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
