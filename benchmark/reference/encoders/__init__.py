"""One file an encoder kind (the configuration's ``encoder.kind``), found by
name. Each gives ``shapes(cfg, img, prefix)``, the encoder's tensors under
``prefix``; ``forward(cfg, p, prefix, x, q, taps, checkpoint)``, NHWC
normalized images to (the tokens after the final norm, the un-normed
tokens after the blocks in ``taps``); ``features(cfg, tokens, img)``,
tokens to an NCHW grid; and ``merged(cfg, p)``, any LoRA folded in for
serving."""
