"""The harness's tests: on the CPU, except those marked ``cuda``, which
decide inside the test whether a card is there."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
