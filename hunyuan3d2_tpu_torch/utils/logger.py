"""Logger factory.

Behavioral parity: hy3dgen/shapegen/utils.py:22-35 (module logger factory with a
single stream handler). Ours adds an env-controlled level (HY3DGEN_TPU_LOGLEVEL).
Copied from hunyuan3d2_tpu/utils/logger.py so the port imports nothing of
the JAX package.
"""

import logging
import os

_LOGGERS = {}


def get_logger(name: str = "hunyuan3d2_tpu_torch") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: %(message)s")
        )
        logger.addHandler(handler)
    level = os.environ.get("HY3DGEN_TPU_LOGLEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    logger.propagate = False
    _LOGGERS[name] = logger
    return logger
