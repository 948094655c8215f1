"""Copy of vision_processor_tpu/utils/log.py for the port.

Lightweight logging with file:line prefixes.

Mirrors the role of the reference's iostream LOG/WARN/FATAL macros
(reference src/log.h:17-21) on top of the stdlib logging module.
"""
from __future__ import annotations

import logging
import sys

_FMT = "[%(levelname).1s %(filename)s:%(lineno)d] %(message)s"

logging.basicConfig(level=logging.INFO, format=_FMT, stream=sys.stderr)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


class Fatal(SystemExit):
    pass


def fatal(msg: str) -> None:
    logging.getLogger("fatal").error(msg)
    raise Fatal(1)
