"""The port's error for a path it has not ported yet.

Every such path raises `not_ported(...)`, naming the ROADMAP.md §A item
that ports it; none falls back to another path on its own.
"""

from __future__ import annotations

NOT_PORTED = "not ported to repro_torch yet (ROADMAP.md §A item {item})"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is " + NOT_PORTED.format(item=item))
