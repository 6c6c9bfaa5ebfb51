"""Schema-named, versioned checkpoint serialization.

TPU-native analog of the reference's save/load system
(``include/svs/lib/saveload/{core,save,load}.h``): every saveable object
declares a ``serialization_schema`` name and a semantic ``save_version``; a
directory checkpoint is a ``svs_config.json`` table plus UUID-named ``.npy``
binary blobs (the reference uses ``svs_config.toml`` + UUID binaries, see
``saveload/core.h:41`` and ``lib/uuid.h``).  Loaders check schema + version and
may register legacy-compatibility paths, mirroring ``load_legacy`` fallbacks in
``index/vamana/index.h:102-174``.

Design properties kept from the reference (SURVEY §5 checkpoint/resume):
  * component-orthogonal directories — config / graph / data are separate
    saveables that can be mixed and matched;
  * schema + semver on every table with explicit compatibility checks;
  * binaries referenced from the config table by UUID filename.
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid as _uuid
from typing import Any, Callable, Dict

import numpy as np

CONFIG_FILENAME = "svs_config.json"
SCHEMA_KEY = "__schema__"
VERSION_KEY = "__version__"


@dataclasses.dataclass(frozen=True)
class Version:
    """Semantic version triple (reference: lib/version.h)."""

    major: int
    minor: int
    patch: int

    @classmethod
    def parse(cls, s: str) -> "Version":
        s = s.lstrip("v")
        major, minor, patch = (int(p) for p in s.split("."))
        return cls(major, minor, patch)

    def __str__(self) -> str:
        return f"v{self.major}.{self.minor}.{self.patch}"

    def __le__(self, other: "Version") -> bool:
        return (self.major, self.minor, self.patch) <= (
            other.major, other.minor, other.patch)

    def __lt__(self, other: "Version") -> bool:
        return (self.major, self.minor, self.patch) < (
            other.major, other.minor, other.patch)


class SaveContext:
    """Tracks the destination directory and generates UUID blob names
    (reference: ``SaveContext`` at lib/saveload/save.h:44)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def save_array(self, array: np.ndarray) -> str:
        """Write a binary blob; return its relative filename."""
        stem = _uuid.uuid4().hex
        np.save(os.path.join(self.directory, stem), np.asarray(array))
        return stem + ".npy"

    def resolve(self, filename: str) -> str:
        return os.path.join(self.directory, filename)


class LoadContext:
    """Resolves blob filenames relative to the checkpoint directory
    (reference: ``LoadContext`` in lib/saveload/load.h)."""

    def __init__(self, directory: str):
        self.directory = directory

    def load_array(self, filename: str) -> np.ndarray:
        return np.load(os.path.join(self.directory, filename))


def save_table(schema: str, version: Version | str, body: Dict[str, Any]) -> Dict[str, Any]:
    """Wrap a body dict with schema + version keys
    (reference: ``SaveTable`` at lib/saveload/save.h:122)."""
    table = {SCHEMA_KEY: schema, VERSION_KEY: str(version)}
    table.update(body)
    return table


class SchemaMismatch(ValueError):
    pass


def check_table(table: Dict[str, Any], schema: str,
                max_version: Version | str) -> Version:
    """Validate schema name and version compatibility; return parsed version."""
    got_schema = table.get(SCHEMA_KEY)
    if got_schema != schema:
        raise SchemaMismatch(
            f"expected schema {schema!r}, checkpoint has {got_schema!r}")
    got = Version.parse(table.get(VERSION_KEY, "v0.0.0"))
    maxv = max_version if isinstance(max_version, Version) else Version.parse(max_version)
    if maxv < got:
        raise SchemaMismatch(
            f"checkpoint schema {schema!r} version {got} is newer than "
            f"supported {maxv}")
    return got


def save_to_disk(obj: Any, directory: str) -> None:
    """Save any object exposing ``save(ctx) -> table`` to a directory
    (reference: ``save_to_disk`` at lib/saveload/save.h:352)."""
    ctx = SaveContext(directory)
    table = obj.save(ctx)
    with open(os.path.join(directory, CONFIG_FILENAME), "w") as f:
        json.dump(table, f, indent=2, default=_json_default)


def read_table(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, CONFIG_FILENAME)) as f:
        return json.load(f)


def load_from_disk(cls: Any, directory: str, **kwargs) -> Any:
    """Load via ``cls.load(table, ctx, **kwargs)``
    (reference: ``load_from_disk`` at lib/saveload/load.h:890)."""
    ctx = LoadContext(directory)
    table = read_table(directory)
    return cls.load(table, ctx, **kwargs)


def try_load_from_disk(cls: Any, directory: str, **kwargs):
    """Non-throwing variant (reference: load.h:954). Returns (ok, value_or_err)."""
    try:
        return True, load_from_disk(cls, directory, **kwargs)
    except (OSError, ValueError, KeyError) as e:  # pragma: no cover - thin wrapper
        return False, e


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


# ---------------------------------------------------------------------------
# Single-stream archive (reference: lib/archiver.h DirectoryArchiver;
# orchestrators/vamana.h:457-535 stream save/load).
# ---------------------------------------------------------------------------

def pack_directory(directory: str, stream) -> None:
    """Pack a checkpoint directory into one binary stream."""
    entries = sorted(os.listdir(directory))
    manifest = []
    blobs = []
    for name in entries:
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            data = f.read()
        manifest.append({"name": name, "size": len(data)})
        blobs.append(data)
    header = json.dumps({"archive": "svs_tpu_archive", "version": "v0.0.1",
                         "files": manifest}).encode()
    stream.write(len(header).to_bytes(8, "little"))
    stream.write(header)
    for blob in blobs:
        stream.write(blob)


def unpack_directory(stream, directory: str) -> None:
    """Unpack a stream produced by :func:`pack_directory`."""
    os.makedirs(directory, exist_ok=True)
    header_len = int.from_bytes(stream.read(8), "little")
    header = json.loads(stream.read(header_len))
    if header.get("archive") != "svs_tpu_archive":
        raise ValueError("not an svs_tpu archive stream")
    for entry in header["files"]:
        with open(os.path.join(directory, entry["name"]), "wb") as f:
            f.write(stream.read(entry["size"]))
