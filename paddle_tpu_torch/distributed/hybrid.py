"""The train step (port of ``paddle_tpu/distributed/hybrid.py``:
``AdamWConfig``, ``adamw_init``, ``adamw_update``, the GPT, LLaMA and
BERT stage models, ``build_train_step`` with every remat plan of
``models/common.py`` and its in-process program cache (``_STEP_CACHE``,
``clear_train_step_cache``) — on ONE device).

The JAX builder compiles a shard_map program over a (dp, pp, mp) mesh.
Here the mesh is one device and the gpipe schedule at pp = 1 is what
remains: the step's loss is the mean over micro-batches of the head
loss, and its gradients those of that mean.  Each micro-batch runs its
own forward and backward and the gradients add up (gradient
accumulation: the same result as one backward of the mean, with one
micro-batch's activations alive at a time).  A ``StageModel`` (embed,
trunk, head) picks the model family, as in JAX: ``gpt_stage_model`` by
default, ``llama_stage_model`` for LLaMA, ``bert_stage_model`` for BERT's
MLM + NSP pretraining, all at pp = mp = 1.  Labels may be a tree (BERT's
``{"mlm": [B, S], "nsp": [B]}``): each micro-batch takes its rows of
every leaf along axis 0, as JAX's ``_tree_reshape_micro`` does.  Meshes
of more than one device, the 1F1B schedule, sequence parallelism and ZeRO
stages are not ported (ROADMAP Queue 1 item 10).

JAX's step donates its params and optimizer state; here ``step``
updates them IN PLACE and returns the same dicts.  A JAX step's params
and AdamW state, passed through ``np.asarray``, enter the port through
``models.common.params_from_numpy`` and :func:`opt_state_from_numpy`,
so a JAX training checkpoint resumes here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..models import bert as bert_mod
from ..models import gpt as gpt_mod
from ..models import llama as llama_mod
from ..models.common import params_from_numpy

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "StageModel",
           "gpt_stage_model", "llama_stage_model", "bert_stage_model",
           "build_train_step",
           "clear_train_step_cache", "opt_state_from_numpy"]


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


def _micro_rows(tree, sl: slice, B: int):
    """Rows ``sl`` of every leaf of a labels tree (a tensor or a dict
    tree of them), each leaf's axis 0 the batch of B."""
    def rows(t):
        if t.dim() == 0 or t.shape[0] != B:
            raise ValueError(f"a labels leaf of shape {tuple(t.shape)} "
                             f"does not lead with the batch {B}")
        return t[sl]
    return _tree_map(rows, tree)


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


def opt_state_from_numpy(state, device=None):
    """The JAX step's AdamW state (``{"m", "v", "step"}`` passed through
    ``np.asarray``) -> the port's: the moments through
    :func:`~..models.common.params_from_numpy` in their own dtype
    (float32, or bfloat16 words), the step count a 0-d int64 tensor (JAX
    keeps it in int32), all on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    return {"m": params_from_numpy(state["m"], dev),
            "v": params_from_numpy(state["v"], dev),
            "step": torch.tensor(int(state["step"]), dtype=torch.int64,
                                 device=dev)}


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
      trunk(params, h)           -> h through the layers (LLaMA: the
                                    residual pair (h, delta) whose add
                                    the head's final norm fuses)
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


def bert_stage_model(cfg, remat=False) -> StageModel:
    """The BERT family (MLM + NSP pretraining, JAX's ``bert_stage_model``
    at pp = mp = 1): embed (token rows + position rows + segment row 0,
    the embedding LayerNorm, cast to the model dtype), the encoder
    layers (no padding mask: the flash kernels on the card), and the
    head ``mlm_masked_loss + nsp_loss_fn`` in float32.  Labels are the
    tree ``{"mlm": [B, S], "nsp": [B]}``; ``remat`` is any plan of
    ``models.common.scan_layers_with_remat``."""
    def embed(p, tok):
        S = tok.shape[-1]
        h = (p["wte"][tok] + p["wpe"][torch.arange(S, device=tok.device)]
             + p["wtt"][0])
        h = bert_mod._layer_norm(h, p["emb_ln_g"], p["emb_ln_b"],
                                 cfg.layer_norm_epsilon)
        return h.to(cfg.dtype)

    def head(p, h, lbl):
        return (bert_mod.mlm_masked_loss(p, h, lbl["mlm"], cfg)
                + bert_mod.nsp_loss_fn(p, h, lbl["nsp"])).float()

    return StageModel(
        embed=embed,
        trunk=lambda p, h: bert_mod.forward_layers(h, p["layers"], cfg,
                                                   remat=remat),
        head=head)


# In-process cache of built train steps, keyed on everything the step's
# closures depend on (model config, num_micro, AdamW config, remat plan,
# moment dtype, device): a rebuild with an identical recipe returns the
# same (step, shard_params, init_opt).  The port has no program to trace;
# what the cache keeps is the built step, its identity and the kernel
# libraries it has loaded.
_STEP_CACHE: Dict[Any, Tuple] = {}


def clear_train_step_cache() -> int:
    """Drop every cached train step; returns how many were held."""
    n = len(_STEP_CACHE)
    _STEP_CACHE.clear()
    return n


def _train_step_cache_key(cfg, num_micro, adamw, remat, moment_dtype, dev):
    """Hashable identity of a built train step, from resolved values
    only; None when the build is not cacheable (a non-dataclass
    config)."""
    if not dataclasses.is_dataclass(cfg):
        return None
    try:
        key = ((type(cfg).__name__, dataclasses.astuple(cfg)),
               int(num_micro), dataclasses.astuple(adamw),
               tuple(remat) if isinstance(remat, (list, tuple)) else remat,
               str(moment_dtype), str(dev))
        hash(key)
    except TypeError:
        return None
    return key


def build_train_step(cfg, num_micro: int = 1,
                     adamw: Optional[AdamWConfig] = None,
                     remat=None, moment_dtype: torch.dtype = torch.float32,
                     device=None, model: Optional[StageModel] = None,
                     cache: bool = True):
    """The one-device train step; ``model`` (a :class:`StageModel`, e.g.
    ``llama_stage_model(cfg, remat)``) picks the family, a ``GPTConfig``
    with ``gpt_stage_model(cfg, remat)`` by default.  ``remat`` (any plan
    of ``models.common.scan_layers_with_remat``; True when None) is read
    only for
    that default: a given model carries its own, and passing both
    raises.

    Returns ``(step, shard_params, init_opt)``:
      * ``shard_params(params)`` -> a fresh copy of the tree on the
        step's device (CUDA unless ``device="cpu"``), each leaf a
        trainable tensor;
      * ``init_opt(params)`` -> AdamW state with ``moment_dtype``
        moments;
      * ``step(params, opt_state, ids, labels)`` -> ``(loss, params,
        opt_state)``: ids [B, S] integer tensors with B divisible by
        ``num_micro``, labels [B, S] or a tree of tensors that each lead
        with B (a micro-batch takes its rows of every leaf); params and
        state are updated in place and returned; loss is a 0-d float32 tensor on the device (the mean
        over micro-batches), read without a host sync.
    ``step.loss_and_grads(params, ids, labels)`` -> ``(loss, grads)``
    is the test surface: exactly what ``step`` feeds the optimizer.
    ``step.data_device`` is the device the step expects its batches on
    (what ``io.prefetch_to_device`` takes), ``step.cache_key`` its key in
    the program cache.

    With ``cache`` (the default) an equal recipe returns the same
    ``(step, shard_params, init_opt)`` from the in-process cache; a given
    ``model`` carries arbitrary closures and is never cached.  Every
    build first points the kernel build cache at ``PT_COMPILE_CACHE_DIR``
    when that is set (``jit.loop.maybe_enable_compile_cache``)."""
    from ..jit.loop import maybe_enable_compile_cache
    maybe_enable_compile_cache()
    dev = resolve_device(device)
    adamw = adamw or AdamWConfig()
    custom_model = model is not None
    if model is not None and remat is not None:
        raise ValueError("build_train_step: pass remat to the stage model "
                         "(e.g. llama_stage_model(cfg, remat)), not beside "
                         "model=")
    if num_micro < 1:
        raise ValueError(f"num_micro must be >= 1, got {num_micro}")
    remat = True if remat is None else remat
    cache_key = None
    if cache and not custom_model:
        cache_key = _train_step_cache_key(cfg, num_micro, adamw, remat,
                                          moment_dtype, dev)
        cached = _STEP_CACHE.get(cache_key)
        if cached is not None:
            return cached
    if model is None:
        model = gpt_stage_model(cfg, remat)

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
                part = model.head(params, h,
                                  _micro_rows(labels, sl, B)) / num_micro
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
    step.data_device = dev
    step.cache_key = cache_key
    result = (step, shard_params, init_opt)
    if cache_key is not None:
        _STEP_CACHE[cache_key] = result
    return result
