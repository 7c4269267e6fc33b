"""The whole step's model FLOPs (``work/model.py``) over the traced
window's device busy time and the card's bf16 peak, in %."""

from benchmark.metrics._common import mfu


def read(run):
    return mfu(run)
