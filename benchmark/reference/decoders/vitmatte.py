"""The flagship's ViTMatte-style decoder (``myvitmatte``): the ViT's tokens
after the final norm, re-gridded bicubically to /16, a detail stream of
three strided 3x3 conv-BN-ReLU blocks over the image, four fusion blocks
(x2 bilinear upsample, concat with the detail, 3x3 conv-BN-ReLU), then one
attention-gated head per marker. The encoder sits at ``encoder.vit.``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.layers import bn_shapes, conv_bn_relu, conv_shapes, head, head_shapes

PREFIX = "encoder.vit."


def shapes(cfg, img: int, enc):
    dec, k = cfg["decoder"], cfg["markers"]
    s = enc.shapes(cfg, img, PREFIX)
    cs, fus = dec["convstream_out"], dec["fusion_out"]
    chans = [3] + list(cs)
    for i in range(len(cs)):
        s.update(conv_shapes(f"decoder.convstream.convs.{i}.conv", chans[i + 1], chans[i], 3,
                             bias=False))
        s.update(bn_shapes(f"decoder.convstream.convs.{i}.bn", chans[i + 1]))
    fin = [cfg["encoder"]["embed_dim"]] + list(fus)
    for i in range(len(fus)):
        s.update(conv_shapes(f"decoder.fusion_blks.{i}.conv.conv", fin[i + 1],
                             fin[i] + chans[-(i + 1)], 3, bias=False))
        s.update(bn_shapes(f"decoder.fusion_blks.{i}.conv.bn", fin[i + 1]))
    for j in range(k):
        s.update(head_shapes(f"decoder.segmentation_head_{j}", fus[-1]))
    return s


def forward(cfg, enc, p, x, training, q, checkpoint):
    dec, eps = cfg["decoder"], cfg["bn_eps"]
    img = x.shape[1]
    tokens, _ = enc.forward(cfg, p, PREFIX, x, q, checkpoint=checkpoint)
    feats = enc.features(cfg, tokens, img)
    if tuple(feats.shape[-2:]) != (img // 16, img // 16):
        feats = F.interpolate(feats, size=(img // 16, img // 16), mode="bicubic",
                              align_corners=False)
    image = x.permute(0, 3, 1, 2)
    details = [image]
    h = image
    for i in range(len(dec["convstream_out"])):
        h = conv_bn_relu(p, f"decoder.convstream.convs.{i}.conv", f"decoder.convstream.convs.{i}.bn",
                         h, eps, training, q, stride=2)
        details.append(h)
    h = feats
    n = len(dec["fusion_out"])
    for i in range(n):
        up = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)
        h = conv_bn_relu(p, f"decoder.fusion_blks.{i}.conv.conv", f"decoder.fusion_blks.{i}.conv.bn",
                         torch.cat([details[n - i - 1], up], dim=1), eps, training, q)
    out = torch.cat([head(p, f"decoder.segmentation_head_{j}", h, eps, training, q)
                     for j in range(cfg["markers"])], dim=1)
    return out.permute(0, 2, 3, 1)
