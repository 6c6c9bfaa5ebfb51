"""IVF parameter dataclasses.

PyTorch counterpart of ``scalablevectorsearch_tpu/index/ivf/params.py`` (pure
Python, copied): ``IVFBuildParameters`` (reference ``include/svs/index/ivf/
common.h:69``) and ``IVFSearchParameters`` (``common.h:151``), with the same
checkpoint tables.
"""

from __future__ import annotations

import dataclasses

from ...lib import saveload

UNSPECIFIED = -1


@dataclasses.dataclass
class IVFBuildParameters:
    """K-means training configuration (common.h:69)."""

    num_centroids: int = 1000
    minibatch_size: int = 10_000
    num_iterations: int = 10
    is_hierarchical: bool = True
    training_fraction: float = 0.1
    seed: int = 0xC0FFEE

    SCHEMA = "ivf_build_parameters"
    VERSION = saveload.Version(0, 0, 1)

    def resolved(self, n: int) -> "IVFBuildParameters":
        p = dataclasses.replace(self)
        p.num_centroids = min(p.num_centroids, n)
        if p.num_centroids < 1:
            raise ValueError("num_centroids must be >= 1")
        if not (0.0 < p.training_fraction <= 1.0):
            raise ValueError("training_fraction must be in (0, 1]")
        p.minibatch_size = min(p.minibatch_size,
                               max(int(n * p.training_fraction), 1))
        return p

    def save_table(self) -> dict:
        return saveload.save_table(self.SCHEMA, self.VERSION,
                                   dataclasses.asdict(self))

    @classmethod
    def from_table(cls, table: dict) -> "IVFBuildParameters":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in table.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class IVFSearchParameters:
    """Runtime search configuration (common.h:151).

    ``n_probes``: number of nearest probe units scanned per query.
    ``k_reorder``: candidate multiplier retained from the posting scan before
    the final top-k; with compressed postings and a rerank dataset the
    k_reorder * k candidates are re-scored at full precision.
    """

    n_probes: int = 10
    k_reorder: int = 1

    SCHEMA = "ivf_search_parameters"
    VERSION = saveload.Version(0, 0, 1)

    def __post_init__(self):
        if self.n_probes < 1 or self.k_reorder < 1:
            raise ValueError("n_probes and k_reorder must be >= 1")

    def save_table(self) -> dict:
        return saveload.save_table(self.SCHEMA, self.VERSION, {
            "n_probes": self.n_probes, "k_reorder": self.k_reorder})

    @classmethod
    def from_table(cls, table: dict) -> "IVFSearchParameters":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        return cls(n_probes=table["n_probes"], k_reorder=table["k_reorder"])
