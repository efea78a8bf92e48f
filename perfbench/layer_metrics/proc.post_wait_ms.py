"""Host milliseconds the dispatch thread waited on the postprocess (the
backpressure of its queue and the final joins) per finished scan
(``stats["stage_ms"]["wait.post"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"] or "wait.post" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["wait.post"] / p["scans"]
