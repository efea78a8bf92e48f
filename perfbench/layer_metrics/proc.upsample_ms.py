"""Host milliseconds of the postprocess's half to model-size upsample of both
maps, with the ess unpack and the masking, per device-path scan
(``stats["stage_ms"]["post.upsample"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["device_scans"] or "post.upsample" not in p["stage_ms"]:
        return None
    return p["stage_ms"]["post.upsample"] / p["device_scans"]
