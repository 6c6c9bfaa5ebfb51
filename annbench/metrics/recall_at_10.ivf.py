"""Mean recall@10 of every query answered in the window, in the IVF cells:
k-means on a 2% sample makes it spread from seed to seed several times
wider than the Vamana cells' ``recall_at_10``, so it keeps a bound of its
own."""

from annbench.readers import recall_at_10 as read  # noqa: F401
