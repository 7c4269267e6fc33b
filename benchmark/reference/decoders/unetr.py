"""The UNETR of ``unet_lora`` (``models/unetr.py``): the un-normed tokens
after four blocks, re-gridded by nearest neighbour to /16, deconvolution
pyramids beside a conv stem over the image, the CellViT decoder of
transposed convolutions, then one attention-gated head per marker. The
encoder sits at ``encoder.model.``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.layers import (batch_norm, bn_shapes, conv, conv_shapes, conv_t, head,
                                        head_shapes)

PREFIX = "encoder.model."
FU = "encoder.feature_upsampler."


def channels(d: int):
    """(skip11, skip12, bottleneck) for an encoder of width ``d``."""
    return (256, 128, 312) if d < 512 else (512, 256, 512)


def extract_layers(depth: int):
    """The four tapped blocks."""
    if depth == 4:
        return (0, 1, 2, 3)
    return tuple(int(v) for v in np.round(np.linspace(depth // 4, depth - 1, 4)))


def shapes(cfg, img: int, enc):
    dec = cfg["decoder"]
    d = cfg["encoder"]["embed_dim"]
    s = enc.shapes(cfg, img, PREFIX)
    skip11, skip12, bottleneck = channels(d)

    def conv_block(name, cin, cout):
        s.update(conv_shapes(f"{name}.block.0", cout, cin, 3))
        s.update(bn_shapes(f"{name}.block.1", cout))

    def deconv_block(name, cin, cout):
        s.update(conv_shapes(f"{name}.block.0", cout, cin, 2, transposed=True))
        s.update(conv_shapes(f"{name}.block.1", cout, cout, 3))
        s.update(bn_shapes(f"{name}.block.2", cout))

    conv_block(f"{FU}convsteam.0", 3, 32)
    conv_block(f"{FU}convsteam.1", 32, 64)
    for j, plan in enumerate(([d, skip11, skip12, 128], [d, skip11, 256], [d, bottleneck])):
        for i in range(len(plan) - 1):
            deconv_block(f"{FU}upsampler{j}.{i + 1}", plan[i], plan[i + 1])
    c0, c1, c2, c3, c4 = 64, 128, 256, bottleneck, d
    s.update(conv_shapes("decoder.bottleneck_upsampler", c3, c4, 2, transposed=True))
    for name, c, n, up in (("decoder3_upsampler", c3, 3, c2), ("decoder2_upsampler", c2, 2, c1),
                           ("decoder1_upsampler", c1, 2, c0), ("decoder0_header", c0, 2, None)):
        conv_block(f"decoder.{name}.0", 2 * c, c)
        for i in range(1, n):
            conv_block(f"decoder.{name}.{i}", c, c)
        if up is None:
            s.update(conv_shapes(f"decoder.{name}.{n}", dec["decoder_out"], c, 1))
        else:
            s.update(conv_shapes(f"decoder.{name}.{n}", up, c, 2, transposed=True))
    for j in range(cfg["markers"]):
        s.update(head_shapes(f"segmentation_head_{j}", dec["decoder_out"]))
    return s


def forward(cfg, enc, p, x, training, q, checkpoint):
    e, eps = cfg["encoder"], cfg["bn_eps"]
    img = x.shape[1]
    _, taps = enc.forward(cfg, p, PREFIX, x, q, taps=extract_layers(e["depth"]),
                          checkpoint=checkpoint)
    feats = [enc.features(cfg, t, img) for t in taps]
    gh, gw = feats[0].shape[-2:]
    if (gh, gw) != (img // 16, img // 16):
        idx = [torch.from_numpy(np.minimum(np.floor(np.arange(img // 16) * g / (img // 16)),
                                           g - 1).astype(np.int64)).to(x.device)
               for g in (gh, gw)]
        feats = [f.index_select(2, idx[0]).index_select(3, idx[1]) for f in feats]

    def conv_block(name, h):
        y = conv(h, p[f"{name}.block.0.weight"], p[f"{name}.block.0.bias"], q, padding=1)
        return F.relu(batch_norm(y, p, f"{name}.block.1", eps, training))

    def deconv_block(name, h):
        h = conv_t(h, p[f"{name}.block.0.weight"], p[f"{name}.block.0.bias"], q, stride=2)
        h = conv(h, p[f"{name}.block.1.weight"], p[f"{name}.block.1.bias"], q, padding=1)
        return F.relu(batch_norm(h, p, f"{name}.block.2", eps, training))

    image = x.permute(0, 3, 1, 2)
    z0 = conv_block(f"{FU}convsteam.1", conv_block(f"{FU}convsteam.0", image))
    zs = []
    for j, n in enumerate((3, 2, 1)):
        h = feats[j]
        for i in range(n):
            h = deconv_block(f"{FU}upsampler{j}.{i + 1}", h)
        zs.append(h)
    z1, z2, z3 = zs
    h = conv_t(feats[3], p["decoder.bottleneck_upsampler.weight"],
               p["decoder.bottleneck_upsampler.bias"], q, stride=2)
    for name, n, skip in (("decoder3_upsampler", 3, z3), ("decoder2_upsampler", 2, z2),
                          ("decoder1_upsampler", 2, z1), ("decoder0_header", 2, z0)):
        h = torch.cat([skip, h], dim=1)
        for i in range(n):
            h = conv_block(f"decoder.{name}.{i}", h)
        last = f"decoder.{name}.{n}"
        if name == "decoder0_header":
            h = conv(h, p[f"{last}.weight"], p[f"{last}.bias"], q)
        else:
            h = conv_t(h, p[f"{last}.weight"], p[f"{last}.bias"], q, stride=2)
    out = torch.cat([head(p, f"segmentation_head_{j}", h, eps, training, q)
                     for j in range(cfg["markers"])], dim=1)
    return out.permute(0, 2, 3, 1)
