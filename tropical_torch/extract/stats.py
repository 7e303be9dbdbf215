"""Funnel statistics of the most recent extraction.

The extraction funnel is printed as ``# of vertices and edges = A/B => C/D,
F faces``; tooling and tests read the same numbers from ``LAST``, which
``subpoly`` rewrites after every call.
"""

from __future__ import annotations

# pre_v/pre_e: vertices/edges after the final insertion, before the |sdf|<eps
# skeleton filter; post_v/post_e: after; n_faces: triangle count.
LAST: dict = {}


def record(pre_v: int, pre_e: int, post_v: int, post_e: int,
           n_faces: int) -> None:
    LAST.clear()
    LAST.update(pre_v=int(pre_v), pre_e=int(pre_e), post_v=int(post_v),
                post_e=int(post_e), n_faces=int(n_faces))
