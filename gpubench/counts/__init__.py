"""Frozen operation and byte counts of the hand-written kernels, one file a
kernel, and the peaks of the card they are held to (``peaks.py``). Copied
from the program's ``chip_smoke.py`` so that a later change to the program
cannot move the yardstick; ``gpubench/tests/test_counts.py`` holds each copy
equal to the original at three shapes."""
