"""CPU checks of the harness, run by path (``python -m pytest
perfbench/checks/<file>.py``); no file here matches ``test_*.py``, so the
repository's own test run does not collect them. The program comes from
``src``."""

import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
