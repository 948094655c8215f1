"""Runs the port's geometry benchmark (``app/geometry_benchmark.py``),
whose ``[Model score]`` line python/overlap_benchmark.py reads.

Usage: python vision_processor_tpu_torch/scripts/geometry_benchmark.py config.yml [--device cpu]

A launcher run as a path, as the dataset harness runs a binary whose name
ends in ``.py`` (python/binary.py); ``python -m
vision_processor_tpu_torch.app.geometry_benchmark`` is the same program. It runs on the
card unless ``--device`` names another device. Standard output is
line-buffered: the harness reads it line by line while the process runs.
"""
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from vision_processor_tpu_torch.app.geometry_benchmark import main

    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(main(sys.argv[1:]))
