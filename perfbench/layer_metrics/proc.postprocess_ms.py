"""Host milliseconds of the processor's postprocess per finished scan
(``stats["stage_ms"]["postprocess"]`` summed over the window's jobs)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["scans"]:
        return None
    return p["stage_ms"]["postprocess"] / p["scans"]
