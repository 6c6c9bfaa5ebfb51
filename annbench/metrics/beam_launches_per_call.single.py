"""The port's kernel launches per call (its five launch counters)."""

from annbench.readers import launches_per_call as read  # noqa: F401
