"""The benchmark's own tests: its modules import by their file names, as
``run.py`` imports them."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
