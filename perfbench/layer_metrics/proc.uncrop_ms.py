"""Host milliseconds of the postprocess's model to crop-size resize of both
maps per finished scan (``stats["stage_ms"]["post.uncrop"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"] or "post.uncrop" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["post.uncrop"] / p["scans"]
