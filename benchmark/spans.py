"""The benchmark's spans around the program's layers, put in only for a
traced run (``--trace 1``), and the shapes of every op call inside them.

- ``bench.attn`` around each call of the encoder's attention entry
  (``attention_qkv`` / ``attention_bshd`` as ``models/vit.py`` calls them),
  and ``bench.attn_bwd`` around that call's autograd backward: identity
  nodes on its inputs and output open and close the span when autograd
  reaches them;
- ``bench.mlp`` around each ``swiglu_fc1`` (the SwiGLU MLP's fc1 and gate);
- ``bench.optim`` around each ``AdamChain.step``;
- ``bench.decoder`` from the first module of the configuration's
  ``decoder_span`` to the end of its last (the decoder and its heads).

Every span records its call's shapes in ``Spans.calls[<op>]``, from which
``work/`` counts the operations and bytes.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.autograd.profiler import record_function


class _Open(torch.autograd.Function):
    """Identity on the op's output; its backward opens the backward span."""

    @staticmethod
    def forward(ctx, out, box):
        ctx.box = box
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        rf = record_function("bench.attn_bwd")
        rf.__enter__()
        ctx.box.append(rf)
        return grad, None


class _Close(torch.autograd.Function):
    """Identity on the op's inputs; its backward closes the backward span."""

    @staticmethod
    def forward(ctx, box, q, k, v):
        ctx.box = box
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return None, gq, gk, gv


class Spans:
    def __init__(self):
        self.calls = defaultdict(list)
        self._undo = []

    def _patch(self, owner, name, wrapper):
        original = getattr(owner, name)
        setattr(owner, name, wrapper(original))
        self._undo.append((owner, name, original))

    def install(self, model: torch.nn.Module, decoder_span) -> "Spans":
        from mipheivit_tpu_torch.models import vit
        from mipheivit_tpu_torch.train import optim

        calls = self.calls

        def attn_bshd(fn):
            def wrapped(q, k, v, num_heads):
                calls["attn"].append((q.shape[0], q.shape[1], q.shape[-1], num_heads,
                                      q.element_size()))
                grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
                box = []
                with record_function("bench.attn"):
                    if grad:
                        q, k, v = _Close.apply(box, q, k, v)
                    out = fn(q, k, v, num_heads)
                    if grad:
                        out = _Open.apply(out, box)
                return out
            return wrapped

        def attn_qkv(fn):
            def wrapped(qkv, num_heads):
                b, s, w = qkv.shape
                calls["attn"].append((b, s, w // 3, num_heads, qkv.element_size()))
                with record_function("bench.attn"):
                    return fn(qkv, num_heads)
            return wrapped

        def mlp(fn):
            def wrapped(x, w, b, **kw):
                calls["mlp"].append((x.numel() // x.shape[-1], x.shape[-1], w.shape[0],
                                     x.element_size()))
                with record_function("bench.mlp"):
                    return fn(x, w, b, **kw)
            return wrapped

        def optim_step(fn):
            def wrapped(self_, *a, **kw):
                with record_function("bench.optim"):
                    return fn(self_, *a, **kw)
            return wrapped

        self._patch(vit, "attention_bshd", attn_bshd)
        self._patch(vit, "attention_qkv", attn_qkv)
        self._patch(vit, "swiglu_fc1", mlp)
        self._patch(optim.AdamChain, "step", optim_step)
        first, last = (model.get_submodule(n) for n in decoder_span)
        box = []

        def enter(_mod, _args):
            rf = record_function("bench.decoder")
            rf.__enter__()
            box.append(rf)

        def leave(_mod, _args, _out):
            if box:
                box.pop().__exit__(None, None, None)

        self._undo.append(first.register_forward_pre_hook(enter))
        self._undo.append(last.register_forward_hook(leave))
        return self

    def remove(self):
        for item in reversed(self._undo):
            if isinstance(item, tuple):
                owner, name, original = item
                setattr(owner, name, original)
            else:
                item.remove()
        self._undo.clear()
