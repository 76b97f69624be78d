"""A python logger with one stream handler (own copy of `optispeech_tpu/utils/pylogger.py`)."""

import logging


def get_pylogger(name: str = __name__) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
