"""Row gather/scatter via one-hot matmuls.

A gather of table rows is written as an (R, K) one-hot matrix times the
(K, F) table, and a scatter-add as its transpose. Because one-hot operands
are exactly 0/1, the product is numerically exact at HIGHEST precision.
This layer was chosen for hardware whose native gather and scatter were
slow; on the GPU, where a native gather or an atomic scatter-add costs
O(R), whether it still pays is not measured yet.

Used for per-ray material-row gathers (shading) and winner-gradient
scatter-adds (the analytic geometry VJP). Falls back to native take /
scatter-add when the table is too large for an (R, K) one-hot to be worth
materializing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this table size the (rays, K) one-hot costs more than it saves.
MAX_ONEHOT_K = 512


def _onehot(idx, k, dtype):
    return (idx[:, None] == jnp.arange(k, dtype=idx.dtype)[None, :]) \
        .astype(dtype)


def gather_rows(table, idx):
    """table (K, F), idx (R,) int -> (R, F)."""
    k = table.shape[0]
    if k > MAX_ONEHOT_K:
        return table[idx]
    oh = _onehot(idx, k, table.dtype)
    return jnp.matmul(oh, table, precision=jax.lax.Precision.HIGHEST)


def scatter_add_rows(idx, contrib, k):
    """Sum contrib (R, F) rows into (k, F) bins by idx (R,)."""
    if k > MAX_ONEHOT_K:
        return jnp.zeros((k, contrib.shape[-1]), contrib.dtype) \
            .at[idx].add(contrib)
    oh = _onehot(idx, k, contrib.dtype)
    return jnp.matmul(oh.T, contrib, precision=jax.lax.Precision.HIGHEST)
