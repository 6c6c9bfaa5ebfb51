"""Mean recall@10 of every query answered in the window, against the
plain reference's exact top-10 (``check.py``)."""

from annbench.readers import recall_at_10 as read  # noqa: F401
