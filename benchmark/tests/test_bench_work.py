"""The op work counters and the model FLOP count against hand sums."""

import pytest

from benchmark import peaks
from benchmark.work import attention, attention_bwd, model, swiglu_fc1


def test_attention_forward():
    # b 2, s 3, 2 heads of 4, bf16: q.k^T and p.v, 2 * b*h*s*s*d each
    assert attention.work(2, 3, 8, 2, 2) == (4.0 * 2 * 2 * 9 * 4, 4.0 * 2 * 3 * 8 * 2)


def test_attention_backward():
    flops, n_bytes = attention_bwd.work(2, 3, 8, 2, 2)
    assert flops == 4 * (2.0 * 2 * 2 * 9 * 4)
    # q, k, v, out, dout read and dq, dk, dv written (2 bytes), the f32 lse
    assert n_bytes == 8 * 2 * 3 * 8 * 2 + 4 * 2 * 2 * 3


def test_swiglu_fc1():
    # x [5, 4], w [6, 4], b [6] read, [5, 3] written
    assert swiglu_fc1.work(5, 4, 6, 2) == (2.0 * 5 * 4 * 6, (20 + 24 + 6 + 15) * 2.0)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 989e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def _cfg(depth):
    return {"generator": "myvitmatte", "markers": 2, "lora_rank": 8, "lora_alpha": 1.0,
            "bn_eps": 1e-5,
            "encoder": dict(kind="vit", patch_size=14, embed_dim=64, depth=depth, num_heads=2,
                            mlp_hidden_dim=128, mlp_type="swiglu", init_values=1e-5,
                            class_token=True, reg_tokens=4, no_embed_class=True, qkv_bias=True,
                            norm_eps=1e-6),
            "decoder": {"kind": "vitmatte", "convstream_out": [8, 8, 8],
                        "fusion_out": [8, 8, 8, 8]}}


def test_one_block_of_the_forward():
    b, img, d, hidden = 3, 128, 64, 128
    s = (img // 14) ** 2 + 5
    per_token = 2 * d * 3 * d + 2 * d * d + 2 * d * 2 * hidden + 2 * hidden * d
    block = b * (s * per_token + 4 * s * s * d)
    assert model.forward_flops(_cfg(3), img, b) - model.forward_flops(_cfg(2), img, b) == block


def test_training_counts_input_gradients_and_lora_weight_gradients():
    b, img, d, hidden, r = 1, 128, 64, 128, 8
    s = (img // 14) ** 2 + 5
    frozen = 2 * d * 3 * d + 2 * d * d + 2 * d * 2 * hidden + 2 * hidden * d
    lora = 2 * (2 * d * r + 2 * r * d)
    forward = s * (frozen + lora) + 4 * s * s * d
    # every product's input gradient, the LoRA products' weight gradients
    backward = s * (frozen + lora) + 2 * 4 * s * s * d + s * lora
    diff = model.train_flops(_cfg(3), img, b) - model.train_flops(_cfg(2), img, b)
    assert diff == b * (forward + backward)
