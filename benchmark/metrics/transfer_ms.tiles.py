"""Device time of the host-to-device and device-to-host copies a batch of
``predict_tiles`` (the uint8 upload and the uint8 fetch), in ms."""

from benchmark.metrics._common import per_batch_ms


def read(run):
    if run.timeline is None:
        return None
    return per_batch_ms(run, run.timeline.device_s(kinds=("h2d", "d2h")))
