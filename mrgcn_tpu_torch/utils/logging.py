"""Logging setup shared by the CLIs (reference: mrgcn/run.py:133-158)."""

from __future__ import annotations

import logging


def init_logger(filename: str, dry_run: bool, verbose: int = 0) -> None:
    if dry_run:
        level = logging.CRITICAL
        if verbose == 1:
            level = logging.INFO
        elif verbose >= 2:
            level = logging.DEBUG
        logging.basicConfig(format="%(message)s", level=level)
        return

    logging.basicConfig(
        filename=filename,
        format="[%(asctime)s] %(module)s/%(funcName)s "
               "| %(levelname)s: %(message)s",
        level=logging.DEBUG)

    if verbose > 0:
        stream_handler = logging.StreamHandler()
        stream_handler.setLevel(
            logging.DEBUG if verbose >= 2 else logging.INFO)
        logging.getLogger().addHandler(stream_handler)
