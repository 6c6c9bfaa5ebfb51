"""Device -> host copies of whole arrays.

PyTorch counterpart of ``scalablevectorsearch_tpu/lib/transfer.py``, kept
as an API alias: the JAX package splits a multi-GB read into row chunks
to keep a remote accelerator link busy; a card on PCIe reads a tensor
back in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from . import datatypes as dt


def to_host_chunked(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a host array in one read.  bfloat16 comes back as
    its raw 2-byte words (``dt.to_host_bits``), as a checkpoint stores
    it."""
    return dt.to_host_bits(t)
