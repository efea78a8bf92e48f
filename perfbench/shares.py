"""The device shares that every kind of cell reports, read from a run's
record (the processor's traced job, the trainer's traced steps).  A
``layer_metrics/<metric>.py`` of them is one of these readers under the
metric's name; each returns ``None`` where the run has nothing to read."""
from perfbench.flops import roofline_seconds


def conv_roofline(rec):
    """Share of the roofline of the ``conv`` kernel class in the traced
    work: the least time of its convolutions (``rec["traced_conv_ops"]``:
    ``flops.conv_ops`` of the reference at the cell's shapes, with the
    input and weight gradients where it trains, times the traced batches or
    steps; per conv the larger of FLOPs over the bf16 peak and bytes over
    the HBM peak) over the class's device time."""
    tr, ops = rec.get("trace"), rec.get("traced_conv_ops")
    if tr is None or not ops:
        return None
    busy = tr.class_seconds(rec["conv_patterns"])
    if busy <= 0:
        return None
    pk = rec["peaks"]
    least, _ = roofline_seconds(ops, pk["bf16_flops"], pk["hbm_bytes_per_s"])
    return 100.0 * least / busy


def mfu(rec):
    """The reference's model FLOPs of the window's finished work (the eval
    forward per scan; the forward and backward per volume, without
    recomputation) over the window's wall time, as a share of the bf16
    peak."""
    if not rec.get("useful_flops") or not rec.get("window_s"):
        return None
    return 100.0 * rec["useful_flops"] / rec["window_s"] / \
        rec["peaks"]["bf16_flops"]


def idle_share(rec):
    """Share of the traced work in which no operation ran on the device."""
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
