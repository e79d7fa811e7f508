"""The benchmark's own tests: the harness and its frozen copies on the CPU
(`python -m pytest benchmark/tests -q` from the repository's root), and the
card-only ones marked `cuda`, which skip where no card is visible."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # benchmark/
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repository
