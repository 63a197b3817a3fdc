"""Journal bytes made durable (``DurableStats.flush_bytes``) per lane of
the window."""


def read(data):
    b = data["counters"].get("flush_bytes")
    n = data["window"]["lanes"]
    return None if b is None or not n else b / n
