"""Milliseconds per traced round inside the program's ``scan`` span (its
tracer, which fences the device at each span's end)."""


def read(data):
    s = data.get("spans")
    if not s or not s["rounds"] or "scan" not in s["seconds"]:
        return None
    return 1e3 * s["seconds"]["scan"] / s["rounds"]
