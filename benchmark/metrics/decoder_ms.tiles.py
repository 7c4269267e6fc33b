"""Device time under the ``bench.decoder`` span (the decoder and its
heads: the configuration's ``decoder_span``) a batch, in ms."""

from benchmark.metrics._common import per_batch_ms


def read(run):
    tl = run.timeline
    if tl is None or not tl.span_count("bench.decoder"):
        return None
    return per_batch_ms(run, tl.device_s("bench.decoder"))
