"""``device.idle_pct``: the share of the window in which the card ran nothing, in %.

100 x (1 - the union of the card's device intervals, kernels and copies
alike, over the window's seconds), the mean over the cards the cell uses.
"""

from portbench.trace import union_s


def read(rec):
    if not rec.cards or rec.window_s <= 0:
        return None
    busy = [union_s([iv for iv in rec.intervals if iv.device == d]) for d in rec.cards]
    return 100.0 * (1.0 - sum(busy) / len(busy) / rec.window_s)
