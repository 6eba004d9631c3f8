"""The flip bar for the tracer's deterministic buffers (a helper of the
tests/test_torch_* files; imports no JAX, so the card's tests use it too).

Two renders of one scene that round differently (XLA against PyTorch, the
card against the CPU) agree on the deterministic buffers except where a
silhouette test (`disc > 0`, `t > 1e-3`) or the checker's floor lands on
the other side: such a pixel differs wholly in normal, depth, alpha or
albedo. The bar: every pixel within 1e-5 + 1e-5*|ref|, except at most
0.2 % of the pixels, each within 1 px of an object silhouette or a checker
edge of the reference (a change of alpha or albedo between neighbours).
"""

import numpy as np

DETERMINISTIC = ("normal", "depth", "alpha", "emission", "environment", "diffuse_color",
                 "glossy_color", "subsurface_color", "transmission_color")
FLIP_SHARE = 0.002


def near_edges(ref) -> np.ndarray:
    """(H, W) bool: within 1 px of a change of alpha or albedo in `ref`."""
    alpha, albedo = np.asarray(ref["alpha"])[..., 0], np.asarray(ref["diffuse_color"])
    edge = np.zeros(alpha.shape, bool)
    for axis in (0, 1):
        jump = (np.diff(alpha, axis=axis) != 0) | (np.abs(np.diff(albedo, axis=axis)).max(-1) > 1e-3)
        lo = [slice(None)] * 2
        hi = [slice(None)] * 2
        lo[axis], hi[axis] = slice(0, -1), slice(1, None)
        edge[tuple(lo)] |= jump
        edge[tuple(hi)] |= jump
    grown = edge.copy()
    h, w = edge.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] |= \
                edge[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return grown


def mismatched(got, ref, names=DETERMINISTIC, atol=1e-5, rtol=1e-5) -> np.ndarray:
    """(H, W) bool: pixels where any of `names` is outside atol + rtol*|ref|."""
    bad = None
    for name in names:
        r = np.asarray(ref[name])
        b = (np.abs(np.asarray(got[name]) - r) > atol + rtol * np.abs(r)).any(-1)
        bad = b if bad is None else bad | b
    return bad


def assert_flips_only(got, ref, names=DETERMINISTIC, atol=1e-5, rtol=1e-5) -> int:
    """The flip bar; returns the number of flipped pixels."""
    bad = mismatched(got, ref, names, atol, rtol)
    off_edge = bad & ~near_edges(ref)
    assert bad.sum() <= FLIP_SHARE * bad.size, (int(bad.sum()), bad.size)
    assert not off_edge.any(), np.argwhere(off_edge)[:10].tolist()
    return int(bad.sum())
