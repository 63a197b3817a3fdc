"""Milliseconds per traced round in the program's ``round`` span outside
every span inside it: plan, lane packing, the recorder's notes, the
result assembly."""


def read(data):
    s = data.get("spans")
    if not s or not s["rounds"]:
        return None
    return 1e3 * s["round_self_s"] / s["rounds"]
