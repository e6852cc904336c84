"""Device mesh construction helpers.

The reference is single-threaded (SURVEY.md §2: parallelism ABSENT); this
layer is designed from scratch for multi-device scale-out. Axes:

- ``data``: images across chips (pure data parallelism — no in-decode
  collectives; the JPEG analogue of DP).
- ``seg``: restart segments of one image across chips (the JPEG analogue of
  sequence parallelism — the bitstream's sequential dependency chain is broken
  at RST markers, and per-segment results are exchanged with collectives).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(n_data: int | None = None, n_seg: int = 1,
              devices=None) -> Mesh:
    """Build a (data, seg) mesh. Defaults to all devices on the data axis."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_seg
    devs = np.array(devices[: n_data * n_seg]).reshape(n_data, n_seg)
    return Mesh(devs, axis_names=("data", "seg"))


def data_sharding(mesh: Mesh, rank: int, axis: int = 0) -> NamedSharding:
    """Shard dimension ``axis`` of a rank-``rank`` array over the data axis."""
    spec = [None] * rank
    spec[axis] = "data"
    return NamedSharding(mesh, P(*spec))
