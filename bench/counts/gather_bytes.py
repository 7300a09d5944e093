"""Bytes that ``gather_rows`` has to move for a set of trees.

A gather of hop h writes one output row of ``d`` float32 values per tree
node and reads one int32 index per node, and reads each distinct source
row at least once. The distinct rows are counted over all the trees of
one iteration at each hop: a kernel split over
shards and time steps may have to read a row once per launch, so this is
the least the work needs, and a share of the bound built on it never
counts the work too high.
"""
from __future__ import annotations

import numpy as np

ROW_ITEM = 4      # float32
INDEX_ITEM = 4    # int32


def tree_bytes(hops: list, feature_dim: int) -> int:
    """``hops[h]``: the vertex ids of hop h of the trees (duplicates
    included)."""
    total = 0
    for ids in hops:
        ids = np.asarray(ids)
        total += ids.size * (feature_dim * ROW_ITEM + INDEX_ITEM)
        total += np.unique(ids).size * feature_dim * ROW_ITEM
    return int(total)
