"""One file a decoder kind (the configuration's ``decoder.kind``), found by
name. Each gives ``shapes(cfg, img, enc)``, every tensor of the generator by
the program's name (the encoder's through ``enc.shapes`` under the prefix
the generator puts it at), and ``forward(cfg, enc, p, x, training, q,
checkpoint)``, normalized NHWC images to NHWC marker maps in (-1, 1)."""
