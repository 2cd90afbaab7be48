"""Small shared utilities (counterpart of spider_tpu/common/utils.py)."""

from __future__ import annotations

import datetime


def now() -> str:
    """Job-id timestamp."""
    return datetime.datetime.now().strftime("%Y%m%d%H%M")[:-1]
