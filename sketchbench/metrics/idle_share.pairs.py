"""The device's idle share of the profiled steps, %: the reader of
``idle_share.hops``, for the cells that report ``pair_rate``."""
from pathlib import Path

from sketchbench.harness import load_module

read = load_module(Path(__file__).with_name("idle_share.hops.py")).read
