"""Host milliseconds of the device path's packing per device-path batch
(``stats["pack_ms"]``)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["device_batches"] or not p["device_scans"]:
        return None
    return p["pack_ms"] / p["device_batches"]
