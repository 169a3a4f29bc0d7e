"""Inputs carried across from the JAX package.

The port has no weights; what it carries across is data. These functions
turn the numpy fields of a `jepsen_tpu.tpu.wgl.PackedBatch` (plus its
`rows()`) and of a `jepsen_tpu.tpu.encode.Encoded` into the port's own
types, so a test can feed both kernels byte-identical inputs. They take
plain arrays, never JAX objects, and import nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import Encoded


def _int32(a, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a), dtype=np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def packed_from_reference(inv_t, ret_t, trans, m, sufmin, row_seg, st0,
                          device) -> tuple[tuple, torch.Tensor,
                                           torch.Tensor]:
    """(packed, row_seg, st0) int32 tensors on `device` for
    kernels.wgl_search: packed = (inv_t, ret_t, trans, m, sufmin)."""
    packed = tuple(_int32(a, device)
                   for a in (inv_t, ret_t, trans, m, sufmin))
    return packed, _int32(row_seg, device), _int32(st0, device)


def encoded_from_reference(inv_t, ret_t, crashed, trans, states,
                           entry_ops, init_state: int = 0) -> Encoded:
    """The port's Encoded over copies of a reference Encoded's arrays
    (states and entry_ops are kept as given)."""
    return Encoded(np.array(inv_t, dtype=np.int32),
                   np.array(ret_t, dtype=np.int32),
                   np.array(crashed, dtype=bool),
                   np.array(trans, dtype=np.int32),
                   list(states), list(entry_ops), int(init_state))
