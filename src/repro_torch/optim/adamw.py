"""AdamW with decoupled weight decay, global-norm clipping, a warmup +
cosine / linear / constant schedule and optional bf16 moments: the JAX
package's ``repro.optim.adamw`` as plain functions on tensors.

Parameters, gradients and the moments are dicts ``name -> tensor`` (the
names of ``nn.Module.named_parameters()``); the state is ``{"m": ...,
"v": ..., "count": 0-d int32 tensor}``, which
:func:`repro_torch.models.convert.tree_to_jax` lays out as the JAX
package's ``{m, v, count}`` tree for a checkpoint.  An update runs in
place under ``torch.no_grad()``, one parameter at a time and
:data:`CHUNK` of its values at a time, in two f32 temporaries (and f32
copies of what is held in another dtype) of at most that many values;
a parameter is written only once they all exist, so a step that fails
part-way can be retried exactly (:func:`apply_updates`).

``torch.optim.AdamW`` is not used: it decays before the moment update,
and has no clip, schedule or ``moment_dtype`` of this kind.  The weight
decay mask matches substrings of the JAX parameter *path*
(``blocks/slot_0/mixer/bq``), so the caller passes each parameter's JAX
path (:func:`repro_torch.models.convert.jax_paths`); an ``nn.Module``
name such as ``layers.3.mixer.bq`` would never contain ``/bq``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Set

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"       # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"  # bfloat16 halves optimizer memory


def schedule_lr(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a tensor or an int), f32."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def init_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig):
    """Zero moments of ``cfg.moment_dtype`` beside each parameter, and a
    zero step count on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    device = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf (a dict's values or an
    iterable of tensors), in f32."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in leaves))


_DECAY_EXEMPT = ("norm", "scale", "bias", "b_", "/bq", "/bk", "/bv",
                 "dt_bias", "A_log", "/D")


def _decay_mask(path_str: str) -> bool:
    return not any(t in path_str for t in _DECAY_EXEMPT)


#: values of one parameter updated at once: its f32 temporaries hold at
#: most this many each (1.25 GiB in all for a bf16 parameter with bf16
#: moments), so the update of deepseek-v2's (160, 5120, 1536) experts
#: does not add 25 GB of temporaries to the step's peak
CHUNK = 1 << 26


def _leaf_buffers(p, m, v):
    """Every f32 temporary of one parameter's update, flat, of at most
    :data:`CHUNK` values: two scratch tensors, and a copy buffer for
    each of ``p``, ``m`` and ``v`` that is held in another dtype (None
    for the f32 ones, which are updated where they lie)."""
    a = torch.empty(min(p.numel(), CHUNK), dtype=F32, device=p.device)
    return (a, torch.empty_like(a),
            *(None if x.dtype == F32 else torch.empty_like(a)
              for x in (p, m, v)))


def _update_leaf(p, g, m, v, scale, bc1, bc2, lr, decay: bool,
                 cfg: AdamWConfig):
    """One parameter's update, written into ``p``, ``m`` and ``v``, one
    chunk of :data:`CHUNK` values after another.  Its temporaries are
    all allocated before the first write, so running out of memory
    leaves the parameter as it was; the arithmetic is the JAX package's,
    operation for operation, in f32 (elementwise, so the chunks do not
    change it)."""
    bufs = _leaf_buffers(p, m, v)
    gf = g.reshape(-1)
    flat = [x.view(-1) for x in (p, m, v)]
    # from here on nothing is allocated
    for lo in range(0, p.numel(), CHUNK):
        hi = min(lo + CHUNK, p.numel())
        a, b = bufs[0][:hi - lo], bufs[1][:hi - lo]
        xs = [x[lo:hi] for x in flat]
        p32, m32, v32 = (x if buf is None else buf[:hi - lo].copy_(x)
                         for x, buf in zip(xs, bufs[2:]))
        a.copy_(gf[lo:hi]).mul_(scale)               # g
        m32.mul_(cfg.b1).add_(torch.mul(a, 1 - cfg.b1, out=b))
        torch.mul(a, 1 - cfg.b2, out=b).mul_(a)      # (1 - b2) * g * g
        v32.mul_(cfg.b2).add_(b)
        torch.div(m32, bc1, out=a)
        a.div_(torch.div(v32, bc2, out=b).sqrt_().add_(cfg.eps))
        if decay:
            a.add_(torch.mul(p32, cfg.weight_decay, out=b))
        p32.sub_(a.mul_(lr))
        for x32, x in zip((p32, m32, v32), xs):
            if x32 is not x:                         # round to its dtype
                x.copy_(x32)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state,
                  cfg: AdamWConfig, paths: Optional[Mapping[str, str]] = None,
                  done: Optional[Set[str]] = None,
                  gnorm: Optional[torch.Tensor] = None):
    """One AdamW step, in place: the parameters and moments are updated
    (the gradients are left as they are).  ``paths`` maps a parameter's
    name to its JAX path for the decay mask (default: the name itself).
    Returns ``(params, new_state, {"grad_norm", "lr"})``, as the JAX
    package.

    A step that fails part-way (say, out of memory in one parameter's
    temporaries) can be run again and gives what one run would: a
    parameter is written only once all its temporaries exist, and its
    name is then added to ``done``, a set the caller keeps across the
    attempts of one step, whose names a later attempt skips.  The count,
    the learning rate and the clip scale come from ``state`` and
    ``grads``, which an attempt does not change.

    ``gnorm`` is the gradients' global norm when ``grads`` are a rank's
    pieces of a model laid out on a mesh (the norm over the whole mesh,
    which the caller computes); by default :func:`global_norm` of
    ``grads``."""
    count = state["count"] + 1
    lr = schedule_lr(cfg, count)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    countf = count.to(F32)
    bc1 = 1 - torch.pow(cfg.b1, countf)
    bc2 = 1 - torch.pow(cfg.b2, countf)
    for name, p in params.items():
        if done is not None and name in done:
            continue
        m, v = state["m"][name], state["v"][name]
        decay = _decay_mask(paths[name] if paths is not None else name)
        _update_leaf(p, grads[name], m, v, scale, bc1, bc2, lr, decay, cfg)
        if done is not None:
            done.add(name)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
