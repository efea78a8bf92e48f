"""Host milliseconds of the zlib compression of both heatmap MHAs per
finished scan (``stats["stage_ms"]["post.zlib"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"] or "post.zlib" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["post.zlib"] / p["scans"]
