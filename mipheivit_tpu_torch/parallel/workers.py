"""Rank workers: what one rank runs under ``parallel.spawn`` in the tests,
the dry run and the chip smoke. Inputs and outputs are numpy arrays and
plain dicts (they cross process boundaries by pickle); each worker runs
inside a started process group and builds what it needs from its
arguments.

- ``seq_attention``: ``seq_sharded_attention`` forward and gradients;
- ``forward``: a ViT or a MipheiViT with ``attn_impl="seq_shard"``;
- ``tp_forward``: a ViT, a MipheiViT (float or int8), a ViT or Swin UNETR
  or a HEMIT generator tensor-parallel (``shard_params``);
- ``tp_int8_accumulator``: an int8 row-split layer's int32 accumulator;
- ``wsi``: ``wsi_inference`` with a ``seq_shard_mesh`` over every rank;
- ``train_steps``: the train step on each rank's rows of global batches,
  data-parallel, sequence-sharded or tensor-parallel;
- ``tasks``: several workers in one process group, in turn.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh, process_device, shard_batch


def _t(a, device=None, requires_grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(process_device() if device is None
                                                       else device)
    return t.requires_grad_(requires_grad)


def _np(t):
    return t.detach().float().cpu().numpy()


def digest(tensors: Dict[str, torch.Tensor]) -> str:
    """sha256 over the bytes of ``tensors`` in name order: replicas compare
    by it."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def seq_attention(q, k, v, num_heads: int):
    """``seq_sharded_attention`` over every rank on whole inputs (``k`` None:
    ``q`` is the fused qkv): the output and the gradients of ``sum(out**2)``
    (summed over the ranks: each holds its shard's rows)."""
    from .seq import seq_sharded_attention

    mesh = make_mesh(1, dist.get_world_size())
    ins = [_t(a, requires_grad=True) for a in ((q,) if k is None else (q, k, v))]
    out = seq_sharded_attention(*ins, num_heads=num_heads, group=mesh.model_group)
    (out.float() ** 2).sum().backward()
    grads = []
    for t in ins:
        g = t.grad.clone()
        dist.all_reduce(g)
        grads.append(_np(g))
    return _np(out), grads


def build_generator(kwargs: dict, out_chans: Optional[int], state=None, device=None,
                    family: str = "mipheivit"):
    """A ViT (``out_chans`` None) or a generator of ``family`` on the rank's
    device, with ``state`` (numpy) loaded when given: ``"mipheivit"`` and
    ``"unetr"`` (a ViT UNETR) of ``ViTConfig(**kwargs)``, ``"unetr_swin"``
    of ``SwinConfig(**kwargs)``, ``"hemit"`` (the dual-branch
    ``ResnetGeneratorSwinT``) of ``kwargs["swin"]`` (``SwinConfig``
    kwargs, its ``img_size`` the generator's) and the generator's other
    arguments in ``kwargs``."""
    from ..infer.loading import load_strict
    from ..models.hemit import ResnetGeneratorSwinT
    from ..models.mipheivit import MipheiViT
    from ..models.swin import SwinConfig
    from ..models.unetr import UnetrSwin, UnetrViT
    from ..models.vit import ViTConfig, VisionTransformer

    with torch.device(process_device() if device is None else device):
        if family == "unetr_swin":
            model = UnetrSwin(SwinConfig(**kwargs), out_chans)
        elif family == "hemit":
            rest = {k: v for k, v in kwargs.items() if k != "swin"}
            swin = SwinConfig(**kwargs["swin"])
            model = ResnetGeneratorSwinT(out_chans, swin.img_size, swin_cfg=swin, **rest)
        elif out_chans is None:
            model = VisionTransformer(ViTConfig(**kwargs))
        else:
            model = {"mipheivit": MipheiViT, "unetr": UnetrViT}[family](ViTConfig(**kwargs),
                                                                      out_chans)
    if state is not None:
        load_strict(model, {k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model


def forward(vit_kwargs: dict, out_chans: Optional[int], state, x, n_model: Optional[int] = None):
    """The eval forward of ``build_generator(...)`` with its tokens sharded
    over ``n_model`` ranks (default: all), the rows of ``x`` split over the
    data axis; returns this rank's output rows."""
    from .seq import seq_shard_scope

    n = dist.get_world_size()
    mesh = make_mesh(n // (n_model or n), n_model or n)
    model = build_generator({**vit_kwargs, "attn_impl": "seq_shard"}, out_chans, state).eval()
    with torch.no_grad(), seq_shard_scope(mesh):
        return _np(model(_t(shard_batch(x, mesh))))


def tp_forward(kwargs: dict, out_chans: Optional[int], state, x, n_model: int = 2,
               family: str = "mipheivit", int8: bool = False):
    """The eval forward of ``build_generator(...)`` with its encoder
    tensor-parallel over ``n_model`` ranks (``shard_params``; with ``int8``
    after ``merge_lora`` and ``quantize_encoder``), the rows of ``x`` split
    over the data axis; returns this rank's output rows."""
    from ..infer.loading import merge_lora, quantize_encoder
    from .sharding import shard_params

    mesh = make_mesh(dist.get_world_size() // n_model, n_model)
    model = build_generator(kwargs, out_chans, state, family=family).eval()
    if int8:
        quantize_encoder(merge_lora(model))
    shard_params(model, mesh)
    with torch.no_grad():
        return _np(model(_t(shard_batch(x, mesh))))


def tp_int8_accumulator(x, w_i8, n_model: int = 2):
    """``sharding.int8_row_accumulator`` on this rank's input columns of
    the whole ``x [M, K]`` and codes ``w_i8 [N, K]`` (K split evenly over
    ``n_model`` ranks, each data row of the mesh alike): ``(acc, sx)`` as
    numpy."""
    from .sharding import int8_row_accumulator

    mesh = make_mesh(dist.get_world_size() // n_model, n_model)
    k = x.shape[1] // n_model
    cols = slice(mesh.model_rank * k, (mesh.model_rank + 1) * k)
    acc, sx = int8_row_accumulator(_t(x[:, cols]), _t(w_i8[:, cols]), mesh.model_group)
    return acc.cpu().numpy(), sx.cpu().numpy()


def _whole(tensors: Dict[str, torch.Tensor], layouts, mesh) -> Dict[str, np.ndarray]:
    """``tensors`` as numpy, each shard of a split tensor (``layouts``)
    gathered over the model group and put back whole."""
    from .sharding import gather_whole

    return {name: _np(gather_whole(t, layouts[name], mesh.model_group) if name in layouts else t)
            for name, t in tensors.items()}


def wsi(vit_kwargs: dict, out_chans: int, state, image, names, mean, std, wsi_kwargs: dict):
    """``wsi_inference`` of a MipheiViT over an ``ArraySlide`` of ``image``
    with its tokens sharded over every rank; rank 0 returns the stitched
    ``[C, H, W]`` uint8 array, the others None."""
    from ..data.stats import Normalizer
    from ..infer.wsi import ArraySlide, wsi_inference

    mesh = make_mesh(1, dist.get_world_size())
    model = build_generator({**vit_kwargs, "attn_impl": "seq_shard"}, out_chans, state).eval()
    h, w = image.shape[:2]
    out = np.zeros((out_chans, h, w), np.uint8) if dist.get_rank() == 0 else None
    norm = Normalizer({"mean": list(mean), "std": list(std)}, "he")
    return wsi_inference(model, ArraySlide(image), out, list(names), norm,
                         seq_shard_mesh=mesh, **wsi_kwargs)


def train_steps(spec: dict) -> dict:
    """``make_train_step`` on this rank's rows of ``spec["batches"]`` (global
    batches) over an ``n_data x n_model`` mesh (``spec["n_model"]``, default
    1; with 2 or more the ViT is sequence-sharded, or tensor-parallel with
    ``spec["tp"]``): a MipheiViT of ``spec["vit"]`` (``spec["family"]``
    ``"myvitmatte"``, the default: LoRA and decoder trainable) or a ViT
    UNETR (``"unet_lora"``: everything trainable), or with ``spec["swin"]``
    (``SwinConfig`` kwargs) a Swin UNETR of the family, with
    ``spec["state"]`` loaded, the weighted-MSE loss of ``spec["weights"]``,
    the pix2pix Adam chains (``lr``, ``total_iters``, ``warmup``, ``accum``), in
    ``spec["dtype"]`` (default float32) and, with ``spec["disc_state"]``,
    the discriminator. Returns the step losses (means over the ranks), the
    first microbatch's reduced gradients and the final state dict (sharded
    tensors gathered whole; with ``spec["return_state"]`` False on no rank,
    ``"rank0"`` on rank 0 alone), the digest of the replicated tensors (all
    of them unless tensor-parallel) and of this rank's shards, the Adam
    moments by name (whole on one process; under ``tp`` this rank's shards
    of the sharded tensors) and the BatchNorms' modes; under ``tp`` with
    ``spec["opt_ref"]`` (one process's moments of the sharded tensors by
    name) also those moments through ``shard_opt_state``."""
    from ..metrics.pixel import PixelMetrics
    from ..models.discriminator import DiscriminatorPatch
    from .seq import seq_shard_scope
    from .sharding import param_layouts, shard_opt_state, shard_params
    from ..train import losses, optim, steps

    n_model = spec.get("n_model", 1)
    tp = spec.get("tp", False)
    family = spec.get("family", "myvitmatte")
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(n // n_model, n_model)
    device = process_device() or torch.device("cpu")
    dtype = getattr(torch, spec.get("dtype", "float32"))
    if "swin" in spec:
        model = build_generator(spec["swin"], spec["out_chans"], spec["state"], device,
                                family="unetr_swin")
    else:
        vit = dict(spec["vit"], attn_impl="seq_shard" if n_model > 1 and not tp else "auto")
        model = build_generator(vit, spec["out_chans"], spec["state"], device,
                                family="unetr" if family == "unet_lora" else "mipheivit")
    model.to(dtype)
    if tp:
        shard_params(model, mesh)
    layouts = param_layouts(model)
    gan = spec.get("disc_state") is not None
    disc = None
    if gan:
        disc = DiscriminatorPatch(3 + spec["out_chans"], ndf=8, n_layers=2)
        disc.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in spec["disc_state"].items()})
    gen_opt = optim.build_generator_optimizer(spec["lr"], spec["total_iters"],
                                              warmup_iters=spec["warmup"],
                                              grad_accum_steps=spec["accum"])
    disc_opt = optim.build_discriminator_optimizer(
        spec["lr"], spec["total_iters"], warmup_iters=spec["warmup"],
        grad_accum_steps=spec["accum"]) if gan else None
    state = steps.create_train_state(model, gen_opt, disc, disc_opt,
                                     freeze_model_name=family, device=device, mesh=mesh,
                                     grad_checkpointing=spec.get("grad_checkpointing", False))
    step = steps.make_train_step(model, losses.weighted_mse_loss(50.0, spec["weights"]),
                                 gen_opt, disc, disc_opt, steps.StepConfig(gan_train=gan))
    metrics = PixelMetrics.zeros(device)
    losses_out, grads0 = [], None
    bn_training = []
    with seq_shard_scope(mesh):
        for i, batch in enumerate(spec["batches"]):
            batch = {k: v.astype(spec.get("dtype", "float32")) for k, v in batch.items()}
            state, metrics, log = step(state, shard_batch(batch, mesh), metrics)
            if i == 0:
                grads0 = _whole(log["grads"], layouts, mesh)
                bn_training = sorted({m.training for m in model.modules()
                                      if type(m).__name__ == "BatchNorm2d"})
            keys = ["gen_loss", "gen_loss_sim"] + (["disc_adv_loss"] if gan else [])
            vals = torch.stack([log[k].double() for k in keys])
            if n > 1:
                dist.all_reduce(vals)
                vals /= n
            losses_out.append(dict(zip(keys, vals.tolist())))
    gen_sd = {k: v for k, v in model.state_dict().items()}
    names = [k for k, _ in state.gen_params]
    opt = state.gen_opt_state
    kept = [i for i, k in enumerate(names) if not tp or k in layouts]
    out = {"losses": losses_out, "grads0": grads0, "bn_training": bn_training,
           "step": state.step,
           "digest": digest({k: v for k, v in gen_sd.items() if k not in layouts}),
           "shard_digest": digest({k: v for k, v in gen_sd.items() if k in layouts}),
           "disc_digest": digest(disc.state_dict()) if gan else None,
           "opt": {names[i]: (_np(opt.mu[i]), _np(opt.nu[i])) for i in kept}}
    if tp and spec.get("opt_ref") is not None:
        # whole moments: one process's of the sharded tensors, this rank's
        # (replicated) of the others
        ref = spec["opt_ref"]
        whole = optim.OptState(
            adam_count=opt.adam_count, schedule_count=opt.schedule_count,
            mu=[torch.from_numpy(ref[k][0]) if k in layouts else m for k, m in zip(names, opt.mu)],
            nu=[torch.from_numpy(ref[k][1]) if k in layouts else v for k, v in zip(names, opt.nu)])
        shard_opt_state(whole, model, mesh)
        out["opt_sliced"] = {names[i]: (_np(whole.mu[i]), _np(whole.nu[i])) for i in kept}
    keep_state = spec.get("return_state", True)
    if keep_state == "rank0":
        keep_state = dist.get_rank() == 0
    whole_sd = _whole(gen_sd, layouts, mesh)       # every rank joins the gathers
    if keep_state:
        out["state"] = {k: v for k, v in whole_sd.items() if gen_sd[k].is_floating_point()}
    else:
        out["grads0"] = None
    return out


def tasks(*calls):
    """``[fn(*args) for fn, args in calls]``: several workers in one process
    group (every rank runs the same calls in the same order)."""
    return [fn(*args) for fn, args in calls]
