"""Milliseconds per traced round inside the durable commit's
``commit.capture`` span: each shard's file plan and the host copy of the
rows its files hold."""


def read(data):
    s = data.get("spans")
    if not s or not s["rounds"] or "commit.capture" not in s["seconds"]:
        return None
    return 1e3 * s["seconds"]["commit.capture"] / s["rounds"]
