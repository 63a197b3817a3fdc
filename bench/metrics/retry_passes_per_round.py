"""Retry passes (the ``retry_passes`` counter) per round of the window."""


def read(data):
    n = data["window"]["rounds"]
    p = data["counters"].get("retry_passes")
    return None if not n or p is None else p / n
