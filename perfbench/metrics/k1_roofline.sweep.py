"""k1_roofline.sweep: K1's share of its bound in the sweep (the larger of
its products at the bf16 peak and its bytes at the memory's peak; at the
cells' shapes the products bound it) over K1's traced device time, in %."""

from perfbench.harness.work import k1_roofline_pct


def read(rec):
    return k1_roofline_pct(rec)
