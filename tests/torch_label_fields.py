"""Seeded 2D fields for the flat-component labelling (kernel L1 and its plain
version): numpy only, shared by the CPU tests against the JAX package and
the card tests.  An edge is flat when |X[next] - X[here]| <= 1e-4 of the
image's scale (``diffprox._SEG_TOL_2D``); every field keeps |X| <= 1, so the
tolerance is 1e-4, and no edge lies within 25% of it.

* ``p0.5`` / ``p0.8``: X = 0.75e-4 k with k uniform on {0..4} / {0..2};
  an edge is flat where |dk| <= 1, 52% / 78% of the edges, so near and
  above the square lattice's percolation threshold (0.5): large, tortuous
  components, and pixels side by side in one component across an edge
  that is not flat (flatness is not transitive).
* ``serpentine`` / ``serpentine_t``: corridors on the even rows (columns)
  joined at alternate ends through walls on the odd ones: one component
  whose path runs through half the image, and one wall component a row.
* ``flat``: one component.  ``none``: a checkerboard of 0 and 1, no flat
  edge.
"""
import numpy as np

STEP = 0.75e-4


def _serpentine(M, N):
    X = np.zeros((M, N))
    for r in range(1, M, 2):
        X[r] = 1.0
        X[r, N - 1 if (r // 2) % 2 == 0 else 0] = 0.0
    return X


def field(kind, M, N, rng):
    """One (M, N) float64 field of the given kind."""
    if kind == "p0.5":
        return STEP * rng.randint(0, 5, (M, N))
    if kind == "p0.8":
        return STEP * rng.randint(0, 3, (M, N))
    if kind == "serpentine":
        return _serpentine(M, N)
    if kind == "serpentine_t":
        return _serpentine(N, M).T.copy()
    if kind == "flat":
        return np.zeros((M, N))
    if kind == "none":
        return np.add.outer(np.arange(M), np.arange(N)) % 2.0
    raise ValueError(kind)


def batch(kinds, M, N, seed=0):
    """(len(kinds), M, N) float64: one image of each kind."""
    rng = np.random.RandomState(seed)
    return np.stack([field(k, M, N, rng) for k in kinds])
