"""Device milliseconds of the device path's unpack and preprocess per
device-path batch (``stats["stage_ms"]["preprocess"]``, CUDA events)."""


def read(rec):
    p = rec.get("proc")
    if not p or not p["device_batches"] or not p["device_scans"]:
        return None
    return p["stage_ms"]["preprocess"] / p["device_batches"]
