"""Runs the port's vision processor (``app/main.py``): one config
runs ``App``, more than one ``MultiCamApp``.

Usage: python vision_processor_tpu_torch/scripts/vision_processor.py config.yml [config.yml ...] [--device cpu]

A launcher run as a path, as the dataset harness runs a binary whose name
ends in ``.py`` (python/binary.py); ``python -m
vision_processor_tpu_torch.app.main`` is the same program. It runs on the
card unless ``--device`` names another device. Standard output is
line-buffered: the harness reads it line by line while the process runs.
"""
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from vision_processor_tpu_torch.app.main import main

    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(main(sys.argv[1:]))
