"""The share of each call spent inside ``search_async`` (host issue)."""

from annbench.readers import dispatch_pct as read  # noqa: F401
