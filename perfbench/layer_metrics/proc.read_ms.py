"""Host milliseconds of the loader workers' MHA reads (the scan and its lobe
map) per finished scan (``stats["stage_ms"]["io.read"]``); a scan that
falls back to the host path is read twice, and that is its cost."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"] or "io.read" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["io.read"] / p["scans"]
