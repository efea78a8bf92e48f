"""Device milliseconds of kernel G, the heatmaps' resampling and uint8
quantisation on the card, per batch of either path
(``stats["stage_ms"]["heatmap"]``, CUDA events)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["batches"] or "heatmap" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["heatmap"] / p["batches"]
