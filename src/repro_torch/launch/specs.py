"""Abstract inputs for every (arch x input-shape) combination: the JAX
package's ``launch/specs.py``.

Where the JAX package has ``ShapeDtypeStruct`` trees from
``jax.eval_shape``, the port has trees of tensors on the ``meta`` device:
shapes and dtypes, no storage.  ``build_case`` returns what one step of a
shape takes (abstract args and their specs, what is donated) and, as the
JAX package's does, the step itself, ``fn``: ``make_train_step(
param_specs=)`` for training, ``Model.prefill`` and ``Model.decode_step``
over a params argument for serving.  ``fn`` runs on the same trees placed
on a mesh (``sharding.distribute``) inside ``utils.pjit_utils.
activation_sharding(mesh, batch_axes, device_mesh)``, for every family
(dense, MoE, vlm, audio, rwkv6, the mamba2/zamba2 hybrid) and the window
variant.  Nothing is compiled.

Every leaf has the JAX package's dtype: int32 tokens, bf16 image
embeddings, bf16 weights where JAX casts them (every float32 leaf of rank
>= 2 *as JAX stacks it*, so a block's norm scales and mixing vectors too),
bf16 caches with float32 SSM and wkv states, float32 moments and masters,
and an int32 optimizer step.  Where the port's own step holds another
dtype, the plan keeps JAX's:
  * ``AdamWState.step`` is a host int in the port; the plan holds JAX's
    int32 scalar (4 bytes, replicated);
  * the port's ``init_train_state`` casts by the per-layer rank, so its
    block vectors stay float32 where JAX's stacked ones are bf16;
  * the port's serving path reads its float32 parameters through a bf16
    copy of the matrices (``Model.weights``), and keeps the rwkv decay
    LoRA in float32; the plan holds JAX's serving tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.configs.shapes import InputShape, get_shape
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.transformer import Model
from repro_torch.train.loop import (TrainConfig, make_optimizer,
                                    make_train_step)

META = torch.device("meta")


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def resolve_arch_for_shape(arch: str, shape_name: str
                           ) -> Tuple[ArchConfig, bool]:
    """Returns (config, is_swa_variant).

    long_500k on a full-attention arch uses the explicitly-labeled
    sliding-window variant (DESIGN.md §4): window 4096 ring cache.
    """
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.long_context == "swa_variant":
        return dataclasses.replace(cfg, sliding_window=4096), True
    return cfg, False


def batch_specs(cfg: ArchConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"tokens": _abstract((b, s, cfg.n_codebooks), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.frontend_tokens
        return {"tokens": _abstract((b, s - p), torch.int32),
                "image_embeds": _abstract((b, p, cfg.d_model),
                                          torch.bfloat16)}
    return {"tokens": _abstract((b, s), torch.int32)}


def decode_token_specs(cfg: ArchConfig, shape: InputShape) -> torch.Tensor:
    b = shape.global_batch
    if cfg.family == "audio":
        return _abstract((b, cfg.n_codebooks), torch.int32)
    return _abstract((b,), torch.int32)


def _cast_as_stacked(model: Model, dtype: torch.dtype):
    """``model``'s tree with every float32 leaf that JAX holds at rank >= 2
    (stack axes counted) in ``dtype``: the JAX package's cast."""
    if model.device != META:
        raise ValueError(f"a plan's model lives on meta, not "
                         f"{model.device}")
    cfg = model.cfg

    def one(path, p):
        stack = sh.jax_stacking(cfg, path, cache=False)[1]
        if p.dtype == torch.float32 and p.dim() + len(stack) >= 2:
            return _abstract(p.shape, dtype)
        return p

    return sh.map_with_path(one, model.tree())


def model_state_specs(model: Model, tc: TrainConfig):
    """Abstract (params, opt_state) of a model on ``meta``: the JAX
    package's ``init_train_state`` (with ``master_weights`` its cast, then
    the optimizer's float32 moments and masters, an int32 step)."""
    params = _cast_as_stacked(model, tc.compute_dtype if tc.master_weights
                              else torch.float32)
    opt = make_optimizer(tc).init(params)
    return params, opt._replace(step=_abstract((), torch.int32))


def cache_specs(model: Model, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16):
    return model.init_cache(batch, max_len, dtype=dtype)


def serve_param_specs(model: Model, dtype: torch.dtype = torch.bfloat16):
    """Serving weights live in bf16 (no optimizer, no masters needed)."""
    return _cast_as_stacked(model, dtype)


def _step_fn(model: Model, kind: str, dtype: torch.dtype, tc=None,
             param_specs=None):
    """The step of ``kind`` over explicit arguments, as ``args`` orders
    them."""
    if kind == "train":
        return make_train_step(model, tc, param_specs=param_specs)
    if kind == "prefill":
        return lambda params, batch, cache: model.prefill(
            batch, cache, dtype, params=params)
    return lambda params, tokens, cache: model.decode_step(
        tokens, cache, dtype, params=params)


def build_case(arch: str, shape_name: str, mesh: MeshSpec,
               compute_dtype: torch.dtype = torch.bfloat16):
    """Everything one (arch x shape) step takes on a mesh.

    Returns dict with: kind, fn (the step: ``fn(*args)`` on the placed
    trees), args (meta trees), in_specs, donate, cfg, variant flag,
    batch_axes.
    """
    cfg, variant = resolve_arch_for_shape(arch, shape_name)
    return build_case_from_cfg(cfg, shape_name, mesh, compute_dtype,
                               variant=variant)


def build_case_from_cfg(cfg: ArchConfig, shape_name: str, mesh: MeshSpec,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        variant: bool = False):
    """build_case for an explicit (possibly depth-modified) config."""
    shape = get_shape(shape_name)
    model = Model(cfg, device=META, seed=None)
    common = dict(cfg=cfg, variant=variant)

    if shape.kind == "train":
        tc = TrainConfig(compute_dtype=compute_dtype,
                         master_weights=compute_dtype != torch.float32)
        params, opt = model_state_specs(model, tc)
        batch = batch_specs(cfg, shape)
        batch_axes = sh.pick_batch_axes(mesh, shape.global_batch,
                                        allow_model=True)
        p_sh = sh.params_shardings(params, cfg, mesh)
        o_sh = sh.opt_shardings(opt, p_sh)
        b_sh = sh.batch_shardings(batch, mesh, batch_axes)
        return dict(kind="train", args=(params, opt, batch),
                    fn=_step_fn(model, "train", compute_dtype, tc, p_sh),
                    in_specs=(p_sh, o_sh, b_sh), donate=(0, 1),
                    batch_axes=batch_axes, **common)

    params = serve_param_specs(model, compute_dtype)
    cache = cache_specs(model, shape.global_batch, shape.seq_len)
    batch_axes = sh.pick_batch_axes(mesh, shape.global_batch,
                                    allow_model=False)
    p_sh = sh.params_shardings(params, cfg, mesh, mode="serve")
    c_sh = sh.cache_shardings(cache, cfg, mesh)
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape)
        b_sh = sh.batch_shardings(batch, mesh, batch_axes)
    else:   # decode: ONE new token against a cache of seq_len
        batch = decode_token_specs(cfg, shape)
        b_sh = sh.batch_shardings({"t": batch}, mesh, batch_axes)["t"]
    return dict(kind=shape.kind, args=(params, batch, cache),
                fn=_step_fn(model, shape.kind, compute_dtype),
                in_specs=(p_sh, b_sh, c_sh), donate=(2,),
                batch_axes=batch_axes, **common)
