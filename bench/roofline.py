"""Least times of the tree kernels (K1-K4) from a round's shapes, and the
chip's published peaks.

A kernel's least time is the larger of its bytes at the HBM rate and its
operations at the peak rate.  Bytes are counted from the round's shapes
(point and range lanes, node width ``b``, scan ``cap``, the rows the range
lanes returned) and from the dictionary the round ran on, as the plain
reference holds it: the fullest tree of width ``b`` over its keys, and per
level the distinct nodes that the point lanes' keys lie in.  Each input
byte is read once and each output byte written once: the work the round
needs, whatever program does it, so a kernel launched more often than the
round needs, over padded lanes, or over a taller or emptier tree, shows as
a lower share.

Peaks: NVIDIA H100 SXM data sheet (dense, 700 W): 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, taken as the rate of the
kernels' integer compares (a lower bound on their time: integer throughput
is below it).  Report a share with the card's ``power.limit`` beside it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# kernel -> substrings of its device kernels' names (csrc/*.cu)
KERNELS: Dict[str, Tuple[str, ...]] = {
    "K1": ("descend_probe_kernel",),
    "K2": ("compact_warp_rows", "compact_block_row"),
    "K3": ("elim_combine_kernel",),
    "K4": ("range_scan_",),
}

KEY, VAL, CHILD, FLAG = 8, 8, 4, 1


def kernel_of(name: str):
    """K1-K4 for a device kernel's name, else None."""
    for k, subs in KERNELS.items():
        if any(s in name for s in subs):
            return k
    return None


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def tree_shape(sorted_keys: np.ndarray, point_keys: np.ndarray, b: int) -> dict:
    """The fullest tree of node width ``b`` over ``sorted_keys`` (``b`` keys
    a leaf, ``b`` children an internal node): its ``height``, and in
    ``touched``, per level from the leaves up, the distinct nodes that hold
    the point lanes' distinct keys, each key at its place in the sorted
    order (an absent key where it would go).  No (a,b)-tree of width ``b``
    over these keys has fewer nodes, so no lane can read fewer."""
    n = int(sorted_keys.size)
    pos = np.minimum(np.searchsorted(sorted_keys, np.unique(point_keys)), max(n - 1, 0))
    touched = []
    per, nodes = b, -(-max(n, 1) // b)  # keys under a node of the level; nodes in it
    while True:
        touched.append(int(np.unique(pos // per).size))
        if nodes <= 1:
            break
        per, nodes = per * b, -(-nodes // b)
    return {"b": int(b), "height": len(touched), "touched": touched}


def round_least(shape: dict) -> Dict[str, Tuple[float, float]]:
    """(bytes, operations) each tree kernel needs for one round.

    ``shape``: ``tree_shape``'s ``b``, ``height`` and ``touched``;
    ``point_lanes``, ``range_lanes``, ``rows`` (rows the range lanes
    returned), ``cap``."""
    b = int(shape["b"])
    h = int(shape["height"])
    touched = [int(n) for n in shape["touched"]]
    p = int(shape["point_lanes"])
    r = int(shape["range_lanes"])
    rows = int(shape["rows"])
    cap = int(shape["cap"])
    internal = (b - 1) * KEY + b * CHILD
    leaf = b * KEY
    out = {}
    if p:
        # K1: queries in; each distinct node on the lanes' paths once; the
        # found value; leaf id, found flag, slot and value out
        nodes = touched[0] * leaf + sum(touched[1:]) * internal
        out["K1"] = (p * KEY + nodes + p * VAL + p * (CHILD + FLAG + CHILD + VAL), p * h * b)
        # K3: op, value, segment flag, head state and value in; the state
        # before and after each op out
        out["K3"] = (p * (4 + VAL + FLAG + FLAG + VAL) + p * 2 * (FLAG + VAL), p * 8)
    if r:
        # K2: per internal level a lane's frontier is at least one node:
        # its b children and itself as candidates (id + flag), one slot out
        out["K2"] = (r * max(h - 1, 0) * ((b + 1) * (CHILD + FLAG) + CHILD + FLAG),
                     r * max(h - 1, 0) * (b + 1))
        # K4: the interval and the rows it returns in; cap rows of keys and
        # values, the count and the truncated flag out
        out["K4"] = (r * 2 * KEY + rows * (KEY + VAL) + r * (cap * (KEY + VAL) + 4 + FLAG),
                     r * 2 + rows * 2)
    return out


def round_least_s(shape: dict) -> Dict[str, float]:
    return {k: least_s(nb, ops) for k, (nb, ops) in round_least(shape).items()}
