"""Logging (counterpart of sailor_tpu/utils/log.py, Runtime/Core/LogMacros.h
and the editor message queue): a timestamped ring buffer of at most 1024
messages that an editor or host process can drain."""

from __future__ import annotations

import collections
import logging
import time

MAX_MESSAGES = 1024

_logger = logging.getLogger("sailor_tpu_torch")
_queue: collections.deque = collections.deque(maxlen=MAX_MESSAGES)


def SAILOR_LOG(msg: str, *args) -> None:
    text = msg % args if args else msg
    _queue.append((time.time(), text))
    _logger.info(text)


def get_log_messages(max_count: int = MAX_MESSAGES) -> list[tuple[float, str]]:
    """Drain up to ``max_count`` queued messages."""
    out = []
    while _queue and len(out) < max_count:
        out.append(_queue.popleft())
    return out
