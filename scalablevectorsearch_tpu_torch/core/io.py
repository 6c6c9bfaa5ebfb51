"""Vector file I/O: ``*vecs`` interchange formats, ``.npy``, and the framework's
native checkpoint blobs.

Analog of the reference's ``include/svs/core/io/vecs.h`` (fvecs/ivecs/hvecs
readers/writers at ``vecs.h:137,195``) and the Python helpers
``bindings/python/src/common.py`` (``read_vecs``/``write_vecs``/``read_npy``).

The ``*vecs`` family stores each row as a little-endian int32 dimension prefix
followed by ``dim`` elements:
    fvecs -> float32, ivecs -> int32, bvecs -> uint8, hvecs -> float16.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_VECS_DTYPES = {
    ".fvecs": np.float32,
    ".ivecs": np.int32,
    ".bvecs": np.uint8,
    ".hvecs": np.float16,
}


def _vecs_dtype(path: str, dtype=None):
    if dtype is not None:
        return np.dtype(dtype)
    ext = os.path.splitext(path)[1]
    if ext not in _VECS_DTYPES:
        raise ValueError(f"cannot infer vecs dtype from extension {ext!r}")
    return np.dtype(_VECS_DTYPES[ext])


def read_vecs(path: str, dtype=None, max_rows: Optional[int] = None) -> np.ndarray:
    """Read a ``*vecs`` file into an (n, dim) array.

    The dimension prefix is validated to be constant across rows
    (reference behavior: vecs.h readers assume uniform dimensionality).
    NumPy parsing only: the JAX package's native mmap loader
    (``lib/native.py``) is not part of this package yet.
    """
    dt = _vecs_dtype(path, dtype)
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.empty((0, 0), dtype=dt)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype="<i4")[0])
    if dim <= 0:
        raise ValueError(f"invalid vecs dimension prefix {dim} in {path}")
    row_bytes = 4 + dim * dt.itemsize
    if raw.size % row_bytes != 0:
        raise ValueError(
            f"{path}: file size {raw.size} is not a multiple of row size "
            f"{row_bytes} (dim={dim}, dtype={dt})")
    n = raw.size // row_bytes
    if max_rows is not None:
        n = min(n, max_rows)
        raw = raw[: n * row_bytes]
    rows = raw.reshape(n, row_bytes)
    dims = rows[:, :4].copy().view("<i4").ravel()
    if not np.all(dims == dim):
        raise ValueError(f"{path}: non-uniform row dimensions")
    return rows[:, 4:].copy().view(dt).reshape(n, dim)


def probe_vecs_shape(path: str, dtype=None) -> tuple:
    """(n, dim) of a ``*vecs`` file from its header + size — no payload
    read (streamed loaders size their shards from this)."""
    dt = _vecs_dtype(path, dtype)
    with open(path, "rb") as f:
        prefix = np.fromfile(f, dtype="<i4", count=1)
        if prefix.size == 0:
            return 0, 0
        dim = int(prefix[0])
        if dim <= 0:
            raise ValueError(f"invalid vecs dimension prefix {dim} in {path}")
        f.seek(0, os.SEEK_END)
        size = f.tell()
    row_bytes = 4 + dim * dt.itemsize
    if size % row_bytes != 0:
        raise ValueError(
            f"{path}: file size {size} is not a multiple of row size "
            f"{row_bytes} (dim={dim}, dtype={dt})")
    return size // row_bytes, dim


def read_vecs_rows(path: str, start: int, count: int,
                   dtype=None) -> np.ndarray:
    """Read rows [start, start+count) of a ``*vecs`` file.

    Row-block streaming primitive: shard-at-load paths
    (``parallel.sharded.shard_dataset_from_file``) read a huge file in
    bounded blocks and never materialize the whole array on the host
    (SURVEY §7 step 8 / Deep-100M feasibility)."""
    dt = _vecs_dtype(path, dtype)
    n, dim = probe_vecs_shape(path, dtype)
    if start < 0 or start > n:
        raise ValueError(f"row start {start} outside [0, {n}]")
    count = max(0, min(count, n - start))
    if count == 0:
        return np.empty((0, dim), dtype=dt)
    row_bytes = 4 + dim * dt.itemsize
    with open(path, "rb") as f:
        f.seek(start * row_bytes)
        raw = np.fromfile(f, dtype=np.uint8, count=count * row_bytes)
    rows = raw.reshape(count, row_bytes)
    dims = rows[:, :4].copy().view("<i4").ravel()
    if not np.all(dims == dim):
        raise ValueError(f"{path}: non-uniform row dimensions")
    return rows[:, 4:].copy().view(dt).reshape(count, dim)


def write_vecs(path: str, data: np.ndarray, dtype=None) -> None:
    """Write an (n, dim) array in ``*vecs`` format."""
    dt = _vecs_dtype(path, dtype if dtype is not None else data.dtype)
    data = np.ascontiguousarray(data, dtype=dt)
    n, dim = data.shape
    row_bytes = 4 + dim * dt.itemsize
    out = np.empty((n, row_bytes), dtype=np.uint8)
    out[:, :4] = np.full((n, 1), dim, dtype="<i4").view(np.uint8)
    out[:, 4:] = data.view(np.uint8).reshape(n, dim * dt.itemsize)
    out.tofile(path)


# ---------------------------------------------------------------------------
# Reference-native ``.svs`` V1 binary format (migration convenience).
# Layout (reference include/svs/core/io/native.h v1::Header): 1024-byte
# header = u64 magic, 16-byte UUID (lib::UUID raw order — byte i of the
# canonical string octets is stored at raw[15 - i], lib/uuid.h flip()),
# u64 num_vectors, u64 dims, zero padding; then the row-major payload.
# The element type lives in the sidecar TOML config in the reference's
# directory layout, so readers must supply it.
# ---------------------------------------------------------------------------

SVS_V1_MAGIC = 0xCAD4A6B2579980FE
SVS_V1_HEADER_SIZE = 1024


def _uuid_str_from_raw(raw: bytes) -> str:
    """lib::UUID raw bytes -> canonical string (reference lib/uuid.h:192)."""
    import uuid as _uuid
    return str(_uuid.UUID(bytes=bytes(raw)[::-1]))


def _uuid_raw_from_str(s: str) -> bytes:
    """Canonical UUID string -> lib::UUID raw byte order (lib/uuid.h:225)."""
    import uuid as _uuid
    return _uuid.UUID(s).bytes[::-1]


def _parse_svs_header(path: str, header: bytes):
    if len(header) < SVS_V1_HEADER_SIZE:
        raise ValueError(f"{path}: truncated svs header")
    magic = int(np.frombuffer(header[:8], dtype="<u8")[0])
    if magic != SVS_V1_MAGIC:
        raise ValueError(
            f"{path}: bad svs magic 0x{magic:x} (not a V1 file)")
    uuid_raw = header[8:24]
    n, dim = (int(v) for v in np.frombuffer(header[24:40], dtype="<u8"))
    return n, dim, uuid_raw


def read_svs_uuid(path: str) -> str:
    """Return the UUID string of an ``.svs`` blob (reference
    ``io::get_uuid``, core/io/native.h:685)."""
    with open(path, "rb") as f:
        _n, _d, raw = _parse_svs_header(path, f.read(SVS_V1_HEADER_SIZE))
    return _uuid_str_from_raw(raw)


def read_svs(path: str, dtype=np.float32) -> np.ndarray:
    """Read a reference-format ``.svs`` V1 binary data file."""
    dt = np.dtype(dtype)
    with open(path, "rb") as f:
        n, dim, _raw = _parse_svs_header(path, f.read(SVS_V1_HEADER_SIZE))
        expected = n * dim * dt.itemsize
        actual = os.path.getsize(path) - SVS_V1_HEADER_SIZE
        if expected != actual:
            raise ValueError(
                f"{path}: header claims {n}x{dim} {dt} ({expected} bytes) "
                f"but payload is {actual} bytes")
        payload = np.fromfile(f, dtype=dt, count=n * dim)
    return payload.reshape(n, dim)


def write_svs(path: str, data: np.ndarray, uuid: str | None = None) -> str:
    """Write a reference-compatible ``.svs`` V1 binary data file.

    ``uuid``: canonical UUID string embedded in the header (random when
    omitted).  The reference resolves blobs by matching this header UUID
    against the one recorded in ``svs_config.toml`` (``io::find_uuid``,
    core/data/simple.h:130-134) — callers persisting a sidecar config must
    record the same UUID there.  Returns the UUID string used."""
    data = np.ascontiguousarray(data)
    import uuid as _uuid
    if uuid is None:
        uuid = str(_uuid.uuid4())
    header = np.zeros(SVS_V1_HEADER_SIZE, dtype=np.uint8)
    header[:8] = np.array([SVS_V1_MAGIC], dtype="<u8").view(np.uint8)
    header[8:24] = np.frombuffer(_uuid_raw_from_str(uuid), dtype=np.uint8)
    header[24:40] = np.array([data.shape[0], data.shape[1]],
                             dtype="<u8").view(np.uint8)
    with open(path, "wb") as f:
        header.tofile(f)
        data.tofile(f)
    return uuid


def find_svs_by_uuid(directory: str, uuid: str) -> Optional[str]:
    """Scan ``directory`` for the ``.svs`` blob whose header UUID matches —
    the reference's blob-resolution path (``io::find_uuid``)."""
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".svs"):
            continue
        path = os.path.join(directory, name)
        try:
            if read_svs_uuid(path) == uuid:
                return path
        except (ValueError, OSError):
            continue
    return None


def read_npy(path: str) -> np.ndarray:
    return np.load(path)


def write_npy(path: str, data: np.ndarray) -> None:
    np.save(path, data)


def read_any(path: str, dtype=None) -> np.ndarray:
    """Dispatch on extension: .npy, .svs, or any of the *vecs formats."""
    if path.endswith(".npy"):
        return read_npy(path)
    if path.endswith(".svs"):
        return read_svs(path, dtype=dtype or np.float32)
    return read_vecs(path, dtype=dtype)


def generate_test_dataset(n: int, n_queries: int, dim: int, seed: int = 0,
                          dtype=np.float32, distribution: str = "clustered"):
    """Synthetic dataset + queries, mirroring the intent of the reference's
    ``generate_test_dataset`` helper (bindings common.py:23-266).

    ``distribution``:

    * ``"clustered"`` (default) — well-separated Gaussian clusters
      (center scale 10 vs unit noise), the easy/benchmark-friendly case.
    * ``"uniform"`` — i.i.d. standard normal rows (an isotropic shell in
      high dim: no cluster structure whatsoever, near-uniform pairwise
      distances — the hard case for entry samplers and coarse quantizers;
      round-4 VERDICT weak-5 asked for a non-clustered control).
    * ``"overlap"`` — Gaussian mixture whose center scale matches the
      point noise (scale 2), so clusters heavily interpenetrate —
      between the two extremes."""
    rng = np.random.default_rng(seed)
    if distribution == "uniform":
        data = rng.normal(size=(n, dim))
        queries = rng.normal(size=(n_queries, dim))
        return data.astype(dtype), queries.astype(dtype)
    if distribution == "overlap":
        scale = 2.0
    elif distribution == "clustered":
        scale = 10.0
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    n_clusters = max(8, n // 512)
    centers = rng.normal(scale=scale, size=(n_clusters, dim))
    assign = rng.integers(0, n_clusters, size=n)
    data = centers[assign] + rng.normal(size=(n, dim))
    q_assign = rng.integers(0, n_clusters, size=n_queries)
    queries = centers[q_assign] + rng.normal(size=(n_queries, dim))
    return data.astype(dtype), queries.astype(dtype)
