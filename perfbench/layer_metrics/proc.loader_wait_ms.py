"""Host milliseconds the dispatch thread waited on the loader for the next
batch, per batch of either path (``stats["stage_ms"]["wait.loader"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["batches"] or "wait.loader" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["wait.loader"] / p["batches"]
