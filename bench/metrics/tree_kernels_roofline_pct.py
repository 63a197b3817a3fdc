"""Least time of the tree kernels K1-K4 for the profiled rounds (bench
roofline: bytes from the rounds' shapes at 3.35 TB/s) over their device
time in the profile, in percent."""


def read(data):
    p = data.get("profile")
    if not p or not p.get("kernels"):
        return None
    device = sum(k["device_s"] for k in p["kernels"].values())
    least = sum(p["least_s"].values())
    return 100.0 * least / device if device > 0 and least > 0 else None
