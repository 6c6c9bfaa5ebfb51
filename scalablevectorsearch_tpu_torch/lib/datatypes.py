"""Data type registry and padding helpers.

PyTorch counterpart of ``scalablevectorsearch_tpu/lib/datatypes.py``.  The
padding rules are kept as they are (feature dims to 128, row counts to the
dtype's sublane tile) so every padded shape matches the JAX package and
state carries across unchanged.  Element types map onto torch dtypes;
bfloat16 arrays that arrive as ``ml_dtypes.bfloat16`` numpy arrays convert
through a ``uint16`` view, so numpy needs no bfloat16 support here.
"""

from __future__ import annotations

import numpy as np
import torch

LANE = 128  # last-dim padding unit (the JAX package's lane width)

_TORCH_DTYPES = {
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}

_DTYPE_ALIASES = {
    "float": "float32",
    "half": "float16",
    "bf16": "bfloat16",
    "f32": "float32",
    "f16": "float16",
    "i8": "int8",
    "u8": "uint8",
}


def torch_dtype(x) -> torch.dtype:
    """Map a name, numpy dtype or torch dtype onto a torch dtype."""
    if isinstance(x, torch.dtype):
        return x
    name = x if isinstance(x, str) else np.dtype(x).name
    name = _DTYPE_ALIASES.get(name, name)
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported element type {x!r}")
    return _TORCH_DTYPES[name]


def numpy_dtype(x) -> np.dtype:
    """The numpy dtype of the same name as a torch dtype (or of a name or
    numpy dtype); bfloat16 has none."""
    name = eltype_name(x)
    if name == "bfloat16":
        raise ValueError("numpy has no bfloat16")
    return np.dtype(name)


def itemsize(dtype) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def sublane(dtype) -> int:
    """Row-count padding tile for a dtype (the JAX package's sublane rule)."""
    size = itemsize(dtype)
    if size >= 4:
        return 8
    if size == 2:
        return 16
    return 32


def pad_to(x: int, multiple: int) -> int:
    """Round ``x`` up to a multiple of ``multiple`` (minimum one tile)."""
    if x <= 0:
        return multiple
    return ((x + multiple - 1) // multiple) * multiple


def padded_dim(dim: int) -> int:
    """Feature dims pad to 128 columns, as in the JAX package."""
    return pad_to(dim, LANE)


def padded_count(n: int, dtype=torch.float32) -> int:
    """Row counts pad to the dtype's sublane tile."""
    return pad_to(n, sublane(dtype))


def pad_matrix(x: np.ndarray, n_pad: int | None = None,
               d_pad: int | None = None, fill=0) -> np.ndarray:
    """Zero-pad a host (n, d) matrix to (n_pad, d_pad)."""
    n, d = x.shape
    if n_pad is None:
        n_pad = padded_count(n, torch_dtype(x.dtype))
    if d_pad is None:
        d_pad = padded_dim(d)
    if n_pad == n and d_pad == d:
        return x
    out = np.full((n_pad, d_pad), fill, dtype=x.dtype)
    out[:n, :d] = x
    return out


def to_torch(x) -> torch.Tensor:
    """Host array -> CPU tensor; ``ml_dtypes.bfloat16`` goes through a
    ``uint16`` view (numpy itself has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:        # torch tensors need writable memory
        x = x.copy()
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host array; bfloat16 comes back as float32 (numpy has no
    bfloat16 without ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def eltype_name(dtype) -> str:
    """The numpy / JAX name of an element type (``"bfloat16"``, never
    ``"torch.bfloat16"``), as checkpoints record it."""
    return str(torch_dtype(dtype)).replace("torch.", "")


def to_host_bits(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host array holding the same bits: bfloat16 comes back as
    raw 2-byte words (numpy dtype ``V2``), which is how ``np.save`` stores
    an ``ml_dtypes.bfloat16`` array; :func:`from_host_bits` inverts it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def from_host_bits(x: np.ndarray, eltype) -> torch.Tensor:
    """Inverse of :func:`to_host_bits`: a raw 2-byte void array (a bfloat16
    blob as ``np.load`` reads it without ml_dtypes) is viewed as
    ``eltype``; any other array becomes a CPU tensor as it is."""
    if x.dtype.kind == "V":
        return to_torch(np.ascontiguousarray(x).view(np.int16)).view(
            torch_dtype(eltype))
    return to_torch(x)
