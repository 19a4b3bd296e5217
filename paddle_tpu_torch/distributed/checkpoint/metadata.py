"""Checkpoint metadata model (port of
``paddle_tpu/distributed/checkpoint/metadata.py``).

A saved state dict is described, per tensor key, by the list of its
saved shards — each a (global_offset, local_shape) box — and a storage
map from a shard to the data file holding its bytes.  The classes and
their fields are JAX's one for one, so a ``0.metadata`` pickle of either
package reads in the other: :mod:`.save_state_dict` writes these
classes under JAX's module path, and :mod:`.load_state_dict` maps that
path back to this module (the rule is set out there).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["LocalTensorMetadata", "LocalTensorIndex", "Metadata"]


@dataclass(frozen=True)
class LocalTensorMetadata:
    """One saved shard of one tensor: its box in the global tensor."""
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str


@dataclass(frozen=True)
class LocalTensorIndex:
    """Key of a saved shard inside the storage map."""
    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclass
class Metadata:
    # tensor key -> all shards that together cover the global tensor
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = field(
        default_factory=dict)
    # shard -> data file (relative to the checkpoint dir) holding it
    storage_metadata: Dict[LocalTensorIndex, str] = field(default_factory=dict)
    # tensor key -> global shape / dtype name
    global_shapes: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    global_dtypes: Dict[str, str] = field(default_factory=dict)
    # the mesh geometry of the save (JAX: hybrid.mesh_geometry); None
    # for a one-device save
    mesh: Optional[dict] = None
    # tensor key -> str(PartitionSpec) of the save (diagnostic)
    specs: Dict[str, str] = field(default_factory=dict)
