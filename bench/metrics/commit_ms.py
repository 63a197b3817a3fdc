"""Mean latency of the window's commits (the ``commit_latency_s``
histogram: every commit of the window, summed, over their number), in ms."""


def read(data):
    v = data["counters"].get("commit_latency_s")
    return 1e3 * sum(v) / len(v) if v else None
