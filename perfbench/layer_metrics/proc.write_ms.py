"""Host milliseconds of both heatmap MHA writes less their compression (the
cast and byte copy of the canvas, the header, the file writes) per
finished scan (``stats["stage_ms"]["post.write"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"] or "post.write" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["post.write"] / p["scans"]
