"""Milliseconds per traced round inside the program's ``recorder.*`` spans:
the flight recorder's elimination notes with their device-to-host copies,
its per-round records with their scan rows, and its scan-phase and occ
notes."""


def read(data):
    s = data.get("spans")
    if not s or not s["rounds"]:
        return None
    t = [v for k, v in s["seconds"].items() if k.startswith("recorder.")]
    return 1e3 * sum(t) / s["rounds"] if t else None
