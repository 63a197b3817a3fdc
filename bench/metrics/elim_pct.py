"""Update lanes the round engine eliminated (``TreeStats.eliminated``) over
the update lanes issued in the window, in percent."""


def read(data):
    n = data["window"]["update_lanes"]
    e = data["counters"].get("eliminated")
    return None if not n or e is None else 100.0 * e / n
