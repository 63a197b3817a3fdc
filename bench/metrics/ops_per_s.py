"""Lanes completed in the window over the window's seconds (host clock)."""


def read(data):
    w = data["window"]
    return w["lanes"] / w["seconds"] if w["rounds"] else None
