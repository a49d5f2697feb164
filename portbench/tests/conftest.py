"""The benchmark's tests: run from the checkout's root with
``python -m pytest portbench/tests``; the ``cuda``-marked ones need a card
(``-m cuda`` on a machine with one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
