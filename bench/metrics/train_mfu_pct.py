"""Model step and device: the window's model FLOPs (``bench.counts.flops``
over the trees' real shapes) per second, over the cell's chips times the
card's float32 peak, in percent."""


def read(win):
    f = win.counts.get("flops")
    if not f or win.peaks is None:
        return None
    return 100.0 * f / win.seconds / (win.chips
                                      * win.peaks["float32_flops_per_s"])
