"""Breadth benchmark: every flagship part through the production
compact path, warm SDF->STL (in-memory), one row per part.

Implementation: gsdf_tpu.cli.breadth_main, also the `gsdf-tpu-breadth`
console script. All four counts are golden gates.

Run on the GPU: python examples/breadth_bench.py
"""
from _common import example_args  # noqa: F401  (ensures gsdf_tpu importable)

from gsdf_tpu.cli import breadth_main

if __name__ == "__main__":
    breadth_main()
