"""Seconds from process start to the end of the warm-up: imports, kernel
load (or build), the holder, the load rounds and the warm-up rounds."""


def read(data):
    return data.get("setup_s")
