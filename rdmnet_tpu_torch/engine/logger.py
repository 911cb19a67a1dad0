"""Console + file logger (twin of ``rdmnet_tpu/engine/logger.py``; reference
geotransformer/engine/logger.py:6-55). The port runs one process, which
is always the main one."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def create_logger(log_file: Optional[str] = None, name: str = "rdmnet_tpu_torch") -> logging.Logger:
    """INFO to stdout, DEBUG to ``log_file`` (directories created). Calling
    it again replaces the logger's handlers, closing the old ones."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    logger.propagate = False

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(console)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s"))
        logger.addHandler(fh)
    return logger
