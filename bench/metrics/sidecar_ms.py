"""Milliseconds per traced round inside the durable commit's forensics
sidecar: the ``sidecar.encode`` span (the recorder's ring as JSON lines)
and the ``sidecar.write`` span (join, CRC, write, fsync, rename)."""


def read(data):
    s = data.get("spans")
    if not s or not s["rounds"]:
        return None
    t = [s["seconds"][k] for k in ("sidecar.encode", "sidecar.write") if k in s["seconds"]]
    return 1e3 * sum(t) / s["rounds"] if t else None
