"""Framework exceptions.

Analog of the reference's ``ANNEXCEPTION`` (``include/svs/lib/exception.h``)
and the search-cancellation predicates threaded through every search entry
point (``index/vamana/index.h:504-518``, ``flat.h:326``, tested by
``tests/integration/cancel.cpp``).  On TPU a dispatched kernel cannot be
interrupted, so cancellation is honored at query-batch boundaries — the
granularity at which the reference's per-thread predicate fires in practice.
"""

from __future__ import annotations


class ANNException(Exception):
    """Base error for index operations."""


class SearchCancelled(ANNException):
    """Raised when a caller-supplied cancellation predicate fires."""


def check_cancel(cancel) -> None:
    if cancel is not None and cancel():
        raise SearchCancelled("search cancelled by predicate")
