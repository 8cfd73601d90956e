"""The benchmark's CPU tests: the repository's root on the path, so that
``nerfbench`` and the port import as the harness imports them."""
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
