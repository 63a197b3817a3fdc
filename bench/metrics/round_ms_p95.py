"""95th percentile of the wall milliseconds of every round in the window
(host clock; each round ends in a device synchronisation)."""
import numpy as np


def read(data):
    ms = data["window"]["round_ms"]
    return float(np.percentile(ms, 95)) if ms else None
