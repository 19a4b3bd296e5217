"""The train step (port of ``paddle_tpu/distributed/hybrid.py``:
``AdamWConfig``, ``adamw_init``, ``adamw_update``, the GPT and LLaMA
stage models and ``build_train_step`` — on ONE device).

The JAX builder compiles a shard_map program over a (dp, pp, mp) mesh.
Here the mesh is one device and the gpipe schedule at pp = 1 is what
remains: the step's loss is the mean over micro-batches of the head
loss, and its gradients those of that mean.  Each micro-batch runs its
own forward and backward and the gradients add up (gradient
accumulation: the same result as one backward of the mean, with one
micro-batch's activations alive at a time).  A ``StageModel`` (embed,
trunk, head) picks the model family, as in JAX: ``gpt_stage_model`` by
default, ``llama_stage_model`` for LLaMA, both at pp = mp = 1.  Meshes of
more than one device, the 1F1B schedule, sequence parallelism and ZeRO
stages are not ported (ROADMAP Queue 1 item 10).

JAX's step donates its params and optimizer state; here ``step``
updates them IN PLACE and returns the same dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from ..models import gpt as gpt_mod
from ..models import llama as llama_mod

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "StageModel",
           "gpt_stage_model", "llama_stage_model", "build_train_step"]


# ---------------------------------------------------------------------------
# AdamW (reference python/paddle/optimizer/adamw.py semantics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamWConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    epsilon: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0


def _leaves(tree):
    """Leaves of a params-shaped dict tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, v) for key, v in tree.items()}
    return fn(tree)


def _unflatten(tree, leaves):
    """The inverse of :func:`_leaves` on a tree of ``tree``'s shape."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(node[key]) for key in sorted(node)}
        return next(it)
    return walk(tree)


def adamw_init(params, moment_dtype: torch.dtype = torch.float32):
    """Zero moments in ``moment_dtype`` (float32 by default, whatever
    the param dtype: the update math runs in float32) and a step count,
    a 0-d int64 tensor on the params' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype,
                                       requires_grad=False)
    dev = _leaves(params)[0].device
    return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int64, device=dev)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step IN PLACE on ``params`` and ``state`` (the JAX
    function returns new trees and its step donates the old ones).

    Global-norm clipping in float32 over all grads; per leaf, the
    moments and the update run in float32,
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, and the result
    is cast back to the param and moment dtypes.  Everything stays on
    the device (no host sync).  Returns (params, state)."""
    state["step"] += 1
    flat_g = _leaves(grads)
    scale = None
    if cfg.grad_clip is not None:
        gnorm = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             .square() for g in flat_g]).sum().sqrt()
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    t = state["step"].to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for p, g, m, v in zip(_leaves(params), flat_g, _leaves(state["m"]),
                          _leaves(state["v"])):
        g32 = g.float() if scale is None else g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32.square()
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.epsilon)
        p32 = p.float()
        p.copy_(p32 - cfg.lr * (update + cfg.weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)
    return params, state


# ---------------------------------------------------------------------------
# Stage models at pp = mp = 1: embed, trunk, head
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageModel:
    """What ``build_train_step`` needs of a model family (the JAX
    contract at pp = mp = 1, without the partition specs):
      embed(params, tok_mb)      -> h for one micro-batch
      trunk(params, h)           -> h through the layers
      head(params, h, lbl_mb)    -> the mean loss of the micro-batch."""
    embed: Callable
    trunk: Callable
    head: Callable


def gpt_stage_model(cfg, remat=True) -> StageModel:
    """The GPT family: embed (token + position rows, cast to the model
    dtype, as JAX's stage embed), the layers, and the head loss (JAX's
    ``_head_loss`` at mp = 1)."""
    def embed(p, tok):
        S = tok.shape[-1]
        return (p["wte"][tok] + p["wpe"][torch.arange(
            S, device=tok.device)]).to(cfg.dtype)

    return StageModel(
        embed=embed,
        trunk=lambda p, h: gpt_mod.forward_layers(h, p["layers"], cfg,
                                                  remat=remat),
        head=lambda p, h, lbl: gpt_mod._head_loss(p, h, lbl, cfg))


def llama_stage_model(cfg, remat=False) -> StageModel:
    """The LLaMA family: the token rows in the model dtype, the layers,
    and the final RMSNorm + LM head through ``chunked_vocab_nll``."""
    return StageModel(
        embed=lambda p, tok: p["wte"][tok].to(cfg.dtype),
        trunk=lambda p, h: llama_mod.forward_layers(h, p["layers"], cfg,
                                                    remat=remat),
        head=lambda p, h, lbl: llama_mod._head_loss(p, h, lbl, cfg))


def build_train_step(cfg, num_micro: int = 1,
                     adamw: Optional[AdamWConfig] = None,
                     remat=None, moment_dtype: torch.dtype = torch.float32,
                     device=None, model: Optional[StageModel] = None):
    """The one-device train step; ``model`` (a :class:`StageModel`, e.g.
    ``llama_stage_model(cfg, remat)``) picks the family, a ``GPTConfig``
    with ``gpt_stage_model(cfg, remat)`` by default.  ``remat`` (False or
    True: full per-layer recompute; True when None) is read only for
    that default: a given model carries its own, and passing both
    raises.

    Returns ``(step, shard_params, init_opt)``:
      * ``shard_params(params)`` -> a fresh copy of the tree on the
        step's device (CUDA unless ``device="cpu"``), each leaf a
        trainable tensor;
      * ``init_opt(params)`` -> AdamW state with ``moment_dtype``
        moments;
      * ``step(params, opt_state, ids, labels)`` -> ``(loss, params,
        opt_state)``: ids/labels [B, S] integer tensors with B divisible
        by ``num_micro``; params and state are updated in place and
        returned; loss is a 0-d float32 tensor on the device (the mean
        over micro-batches), read without a host sync.
    ``step.loss_and_grads(params, ids, labels)`` -> ``(loss, grads)``
    is the test surface: exactly what ``step`` feeds the optimizer."""
    dev = resolve_device(device)
    adamw = adamw or AdamWConfig()
    if model is None:
        model = gpt_stage_model(cfg, True if remat is None else remat)
    elif remat is not None:
        raise ValueError("build_train_step: pass remat to the stage model "
                         "(e.g. llama_stage_model(cfg, remat)), not beside "
                         "model=")
    if num_micro < 1:
        raise ValueError(f"num_micro must be >= 1, got {num_micro}")

    def loss_and_grads(params, ids, labels):
        B = ids.shape[0]
        if B % num_micro:
            raise ValueError(
                f"batch {B} is not divisible by num_micro {num_micro}; "
                f"pick a micro-batch count that divides it")
        mb = B // num_micro
        leaves = _leaves(params)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc = None
        for i in range(num_micro):
            sl = slice(i * mb, (i + 1) * mb)
            with torch.enable_grad():
                h = model.trunk(params, model.embed(params, ids[sl]))
                part = model.head(params, h, labels[sl]) / num_micro
                grads = torch.autograd.grad(part, leaves)
            loss += part.detach()
            if acc is None:
                acc = list(grads)
            else:
                for a, g in zip(acc, grads):
                    a += g
        return loss, _unflatten(params, acc)

    def step(params, opt_state, ids, labels):
        loss, grads = loss_and_grads(params, ids, labels)
        adamw_update(params, grads, opt_state, adamw)
        return loss, params, opt_state

    def shard_params(params) -> Dict:
        return _tree_map(lambda p: p.detach().to(dev, copy=True)
                         .requires_grad_(p.is_floating_point()), params)

    def init_opt(params):
        return adamw_init(params, moment_dtype=moment_dtype)

    step.loss_and_grads = loss_and_grads
    return step, shard_params, init_opt
