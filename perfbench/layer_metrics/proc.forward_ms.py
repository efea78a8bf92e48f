"""Device milliseconds of the eval forward per batch, both paths
(``stats["stage_ms"]["forward"]``, CUDA events)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["batches"]:
        return None
    return p["stage_ms"]["forward"] / p["batches"]
