"""Frozen-dataclass helper."""

from __future__ import annotations

import dataclasses


def replace(obj, **changes):
    """dataclasses.replace that reads naturally at call sites."""
    return dataclasses.replace(obj, **changes)
