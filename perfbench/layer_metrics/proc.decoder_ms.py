"""Device milliseconds of the eval forward's decoder (us1, us2, us3 and
the heads) per batch of either path (``stats["stage_ms"]["decoder"]``,
CUDA events from the model's ``decoder`` mark to the forward's end)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["batches"] or "decoder" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["decoder"] / p["batches"]
