"""mfu.sweep: the model FLOPs of the batches the traced run's window
finished (counted on the reference at the cell's shapes) a second, outside
the traced spans, at the card's bf16 peak, in %."""

from perfbench.harness.work import mfu_pct


def read(rec):
    return mfu_pct(rec) if rec.get("batches") else None
