"""Megabytes uploaded per device-path scan (``stats["upload_bytes"]``: the
gated CT stream, gate bits, lung bits, extents and moments)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["device_scans"]:
        return None
    return p["upload_bytes"] / p["device_scans"] / 1e6
