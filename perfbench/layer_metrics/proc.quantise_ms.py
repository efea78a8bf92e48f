"""Host milliseconds of the postprocess's uint8 windowing of both maps and
their paste into the scan-size canvas per finished scan
(``stats["stage_ms"]["post.quantise"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"] or "post.quantise" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["post.quantise"] / p["scans"]
