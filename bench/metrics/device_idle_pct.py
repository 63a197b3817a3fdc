"""Share of the profiled stretch's wall time in which no operation ran on
the device, in percent."""


def read(data):
    p = data.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (p["window_s"] - p["busy_s"]) / p["window_s"]
