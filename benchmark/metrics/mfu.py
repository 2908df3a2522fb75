"""The whole step's share of the card's peak, %: the operations of one unit
of the cell's work (a stroke, a batch, a training step), counted once by
FlopCounterMode over the plain reference at the cell's shapes, times the
units the traced window completed, over the window and the peak of the
configuration's precision."""

from benchmark.core import generator
from benchmark.yardstick.bounds import PEAK_OPS_PER_S


def read(run):
    if not run.work or not run.window_s:
        return None
    peak = PEAK_OPS_PER_S["tf32" if run.config.get("tf32") else run.config["dtype"]]
    flops = generator(run.traffic["kind"]).unit_flops(run)
    return 100.0 * run.work * flops / run.window_s / peak
