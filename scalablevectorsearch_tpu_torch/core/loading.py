"""Schema-dispatched dataset loading.

PyTorch counterpart of ``scalablevectorsearch_tpu/core/loading.py``: a saved
dataset directory is identified by the ``__schema__`` key of its config
table and routed to the registered dataset class.  The three built-in
datasets (``VectorDataset``, ``SQDataset``, ``LVQDataset``) are registered,
so a checkpoint written by either package loads here.
"""

from __future__ import annotations

from typing import Any, Dict

from ..lib import saveload

_DATASET_REGISTRY: Dict[str, Any] = {}


def register_dataset(cls) -> Any:
    """Register a dataset class by its SCHEMA for load dispatch."""
    _DATASET_REGISTRY[cls.SCHEMA] = cls
    return cls


def dispatch_load(directory: str, **kwargs):
    """Load whatever dataset type lives in ``directory``; ``kwargs`` go to
    its ``load`` (``device="cuda"`` unless given; ``dtype`` and
    ``capacity`` for a ``VectorDataset``)."""
    table = saveload.read_table(directory)
    schema = table.get(saveload.SCHEMA_KEY)
    cls = _DATASET_REGISTRY.get(schema)
    if cls is None:
        raise ValueError(
            f"no dataset registered for schema {schema!r} "
            f"(known: {sorted(_DATASET_REGISTRY)})")
    return cls.load(table, saveload.LoadContext(directory), **kwargs)


def _register_builtin():
    from ..quantization.lvq import LVQDataset
    from ..quantization.scalar import SQDataset
    from .data import VectorDataset
    for cls in (VectorDataset, SQDataset, LVQDataset):
        register_dataset(cls)


_register_builtin()
