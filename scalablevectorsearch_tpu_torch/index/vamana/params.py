"""Vamana parameter dataclasses.

Analogs of the reference's ``VamanaBuildParameters``
(``include/svs/index/vamana/build_params.h:29-74``),
``SearchBufferConfig`` / ``VamanaSearchParameters``
(``search_buffer.h:39``, ``search_params.h:27-62``), with the same defaulting
and alpha-vs-distance validation rules as ``index.h:1056-1107``.
All are JSON-serializable through the saveload schema system.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...lib import saveload
from ...ops import distance as dist_ops

UNSPECIFIED = -1


@dataclasses.dataclass
class VamanaBuildParameters:
    """Graph construction hyper-parameters (build_params.h:29-74)."""

    alpha: float = UNSPECIFIED           # default depends on distance
    graph_max_degree: int = 32           # R
    window_size: int = 200               # build-time search window
    max_candidate_pool_size: int = UNSPECIFIED   # default 3 * window_size
    prune_to: int = UNSPECIFIED          # default R - 4 (R if R < 16)
    use_full_search_history: bool = True

    SCHEMA = "vamana_build_parameters"
    VERSION = saveload.Version(0, 0, 1)

    def resolved(self, distance) -> "VamanaBuildParameters":
        """Apply the reference's defaulting + validation rules
        (index.h:1056-1107): alpha defaults to 1.2 for L2 and 0.95 for
        MIP/cosine; alpha must be >= 1 for L2 and <= 1 for MIP/cosine;
        prune_to defaults to max_degree - 4 (min 1); pool size to 750."""
        distance = dist_ops.as_distance(distance)
        p = dataclasses.replace(self)
        is_l2 = distance == dist_ops.DistanceType.L2
        if p.alpha == UNSPECIFIED:
            p.alpha = 1.2 if is_l2 else 0.95
        if is_l2 and p.alpha < 1.0:
            raise ValueError(
                f"alpha must be >= 1 for L2 builds, got {p.alpha}")
        if not is_l2 and p.alpha > 1.0:
            raise ValueError(
                f"alpha must be <= 1 for {distance.value} builds, got "
                f"{p.alpha}")
        if p.alpha <= 0:
            raise ValueError("alpha must be positive")
        if p.prune_to == UNSPECIFIED:
            p.prune_to = (p.graph_max_degree - 4
                          if p.graph_max_degree >= 16 else p.graph_max_degree)
        if p.prune_to > p.graph_max_degree:
            raise ValueError("prune_to must be <= graph_max_degree")
        if p.max_candidate_pool_size == UNSPECIFIED:
            p.max_candidate_pool_size = 3 * p.window_size
        if p.graph_max_degree < 2:
            raise ValueError("graph_max_degree must be >= 2")
        return p

    def save_table(self) -> dict:
        return saveload.save_table(self.SCHEMA, self.VERSION,
                                   dataclasses.asdict(self))

    @classmethod
    def from_table(cls, table: dict) -> "VamanaBuildParameters":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in table.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class SearchBufferConfig:
    """Window vs retained-capacity split (search_buffer.h:39).

    ``capacity_defaulted`` records whether the capacity came from the
    single-argument form: the reference resets BOTH window and capacity to
    ``num_neighbors`` when a single-arg config's capacity is below k
    (index.h:582), so single-arg sub-k windows keep that k-floor here too;
    explicit window/capacity splits may legally sit below k (the sub-k
    multi-pop serving points, PERF.md round 3)."""

    search_window_size: int = 32
    search_buffer_capacity: int = UNSPECIFIED
    capacity_defaulted: bool = dataclasses.field(
        default=False, compare=False, repr=False)

    def __post_init__(self):
        if self.search_buffer_capacity == UNSPECIFIED:
            object.__setattr__(self, "search_buffer_capacity",
                               self.search_window_size)
            object.__setattr__(self, "capacity_defaulted", True)
        if self.search_buffer_capacity < self.search_window_size:
            raise ValueError("capacity must be >= window size")
        if self.search_window_size < 1:
            raise ValueError("search_window_size must be >= 1")


@dataclasses.dataclass(frozen=True)
class VamanaSearchParameters:
    """Runtime search configuration (search_params.h:27-62).

    ``prefetch_lookahead`` / ``prefetch_step`` have no TPU meaning (HBM
    gathers are issued in bulk); they are retained for API parity and
    checkpoint compatibility.  ``max_iters`` bounds the lockstep loop
    (UNSPECIFIED -> derived from the window).
    """

    buffer_config: SearchBufferConfig = dataclasses.field(
        default_factory=SearchBufferConfig)
    search_history: bool = False      # visited-set analog: tracked pool
    # cross-iteration visited filter (reference search_buffer_visited_set,
    # search_params.h / filter.h:46): drop candidates already expanded even
    # after their beam entry was evicted.  Off by default, like the
    # reference — the beam's visited flags bound revisits in practice.
    visited_set: bool = False
    prefetch_lookahead: int = 0
    prefetch_step: int = 0
    max_iters: int = UNSPECIFIED

    SCHEMA = "vamana_search_parameters"
    VERSION = saveload.Version(0, 0, 1)

    def with_window(self, window: int,
                    capacity: Optional[int] = None) -> "VamanaSearchParameters":
        return dataclasses.replace(
            self, buffer_config=SearchBufferConfig(
                window, capacity if capacity is not None else UNSPECIFIED))

    def resolved_max_iters(self) -> int:
        from .search import default_max_iters
        if self.max_iters != UNSPECIFIED:
            return self.max_iters
        return default_max_iters(self.buffer_config.search_window_size)

    def save_table(self) -> dict:
        return saveload.save_table(self.SCHEMA, self.VERSION, {
            "search_window_size": self.buffer_config.search_window_size,
            "search_buffer_capacity": self.buffer_config.search_buffer_capacity,
            "search_history": self.search_history,
            "visited_set": self.visited_set,
            "prefetch_lookahead": self.prefetch_lookahead,
            "prefetch_step": self.prefetch_step,
            "max_iters": self.max_iters,
        })

    @classmethod
    def from_table(cls, table: dict) -> "VamanaSearchParameters":
        saveload.check_table(table, cls.SCHEMA, cls.VERSION)
        return cls(
            # equal saved window/capacity is indistinguishable from the
            # single-arg form; treat it as such so legacy checkpoints keep
            # the reference's k-floor (index.h:582)
            buffer_config=SearchBufferConfig(
                table["search_window_size"],
                (UNSPECIFIED
                 if table["search_buffer_capacity"]
                 == table["search_window_size"]
                 else table["search_buffer_capacity"])),
            search_history=table.get("search_history", False),
            visited_set=table.get("visited_set", False),
            prefetch_lookahead=table.get("prefetch_lookahead", 0),
            prefetch_step=table.get("prefetch_step", 0),
            max_iters=table.get("max_iters", UNSPECIFIED),
        )
