"""Fill-reducing orderings for the supernodal plan.

Port of ``ndtpu/native/__init__.py::rcm_order`` by its scipy route: a
reverse Cuthill-McKee ordering of the pose graph. The reference prefers a
g++-built library where one builds and falls back to this route; its
callers take any permutation, so no numerical result depends on which RCM
ran (the plan's separator may differ in size).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rcm_order"]


def rcm_order(edges_i, edges_j, n_vertices: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (position -> vertex), int32."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ei = np.ascontiguousarray(edges_i, np.int32)
    ej = np.ascontiguousarray(edges_j, np.int32)
    a = coo_matrix((np.ones(len(ei)), (ei, ej)),
                   shape=(n_vertices, n_vertices))
    return np.asarray(reverse_cuthill_mckee((a + a.T).tocsr(),
                                            symmetric_mode=True), np.int32)
