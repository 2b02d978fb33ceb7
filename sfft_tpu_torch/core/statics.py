"""Static host tables and their device copies, keyed by how they are built.

A host-to-device copy from pageable memory synchronises the stream, so a
step that uploads its static tables (phase and DFT matrices, power sums,
gather plans, their integer slices) drains the device queue at every upload
and then waits for the host. Here a static table is named by a ``Static``:
the function that builds it and the hashable arguments it is built from
(geometry, degrees, a config). The host array and each device copy are
built at first use and kept in bounded LRU caches keyed by that name (and
the dtype and device), so later steps neither rebuild, hash nor upload
anything. This is the role sfft_tpu's ``_intern`` and jit constants play
for XLA.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple

import numpy as np
import torch

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
              torch.complex128: np.complex128, torch.complex64: np.complex64,
              torch.int64: np.int64, torch.int32: np.int32, torch.int8: np.int8,
              torch.bool: np.bool_}


class Static(NamedTuple):
    """The host table ``build(*args)``, where arguments that are themselves
    ``Static`` stand for their host tables (``Static(np.real, (W,))`` is
    W's real part). build and args must be hashable: module-level functions
    and tuples of numbers, strings and configs."""

    build: Callable
    args: tuple = ()

    def host(self) -> np.ndarray:
        return _host(self)


@lru_cache(maxsize=512)
def _host(ref: Static):
    return ref.build(*(a.host() if isinstance(a, Static) else a for a in ref.args))


@lru_cache(maxsize=512)
def table(ref: Static, device: torch.device, dtype: torch.dtype = None) -> torch.Tensor:
    """The host table of `ref` (converted to the torch `dtype`, when given)
    as a tensor on `device`, built and uploaded once."""
    a = np.asarray(ref.host())
    if dtype is not None:
        a = a.astype(_NP_DTYPES[dtype])
    return torch.tensor(a, device=device)


def index(a, device: torch.device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """A static index list as a tensor on `device`, uploaded once per list."""
    return table(Static(np.array, (tuple(int(v) for v in a),)), device, dtype)
