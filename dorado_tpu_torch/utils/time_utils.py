"""Timestamp formatting (parity: dorado/utils/time_utils.cpp:51-66)."""

from __future__ import annotations

import datetime


def timestamp_from_unix_ms(ms: int) -> str:
    """ISO-8601 with microsecond precision and +00:00 offset, e.g.
    ``2023-05-12T09:50:12.456000+00:00``."""
    dt = datetime.datetime.fromtimestamp(ms / 1000.0, tz=datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f+00:00")


def timestamp_from_unix_s(s: int) -> str:
    dt = datetime.datetime.fromtimestamp(s, tz=datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")
