"""Runs the port's blob benchmark (``app/blob_benchmark.py``), whose
``[BlobMachine]`` line python/blob_benchmark.py reads.

Usage: python vision_processor_tpu_torch/scripts/blob_benchmark.py config.yml [--device cpu]

A launcher run as a path, as the dataset harness runs a binary whose name
ends in ``.py`` (python/binary.py); ``python -m
vision_processor_tpu_torch.app.blob_benchmark`` is the same program. It runs on the
card unless ``--device`` names another device. Standard output is
line-buffered: the harness reads it line by line while the process runs.
"""
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from vision_processor_tpu_torch.app.blob_benchmark import main

    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(main(sys.argv[1:]))
