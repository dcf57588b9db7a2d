"""Guarded batched and continuous-batching serving of the port's LM.

``Server``
    Fixed-batch serving: prefill (all prompts at once, so an MoE
    layer's capacity follows batch x prompt length, as in the JAX
    package), then one decode step per generated token over the
    contiguous caches ((K, V), MLA's compressed pair, a Mamba layer's
    (ssm_state, conv_state), zamba2's shared block's (K, V)), with
    EOS-aware slot masking.  With ``cfg.attn_decode_kernel ==
    "blockspace"`` every GQA decode attention (the shared block's too)
    runs the block-space flash kernel (``seq_pos`` truncation); with
    ``"xla"`` the plain masked decode.  MLA's absorbed decode and the
    Mamba recurrences run no kernel under either.  Prompts are tokens:
    an embedding-input configuration is refused, as the JAX package's
    Server takes token prompts only.

``PagedServer``
    Continuous batching over the paged KV pool (GQA stacks, dense or
    MoE): requests stream through a fixed set of slots; admission
    prefills one request (batch 1: another MoE capacity than a batched
    prefill's, as in the JAX package) and scatters
    its KV into freshly allocated pages; every step advances all active
    slots at their own positions through the paged decode kernel; pages
    grow on demand, and when the pool runs dry the youngest request is
    preempted and later replayed (recompute-style preemption).

Robustness model (see :mod:`repro_torch.runtime`), as in the JAX
package:

* every prefill/decode call runs under a
  :class:`~repro_torch.runtime.guard.GuardedCall` -- per-call deadline,
  NaN/inf output screens, transient-vs-fatal classification, jittered
  backoff retries (``ServeConfig(guard=False)`` calls the steps bare);
* sampling keys derive from ``(seed, slot or request id, position)``
  (:func:`~repro_torch.runtime.guard.sample_key`), so a retried or
  resumed decode step reproduces the identical stream;
* repeated failure walks a :class:`DegradationLadder`
  (blockspace -> xla decode, an exotic lowering -> closed_form; paged:
  paged-blockspace -> paged-xla), switching the config the decode step
  runs under, recording each transition and warning.  A step down
  happens only after the guard's retries of a transient failure are
  exhausted; a fatal error is reported and re-raised on its own rung
  (the JAX package steps down on it too), and on the card the
  constructor builds the kernel libraries first, so a build failure
  raises there;
* SIGTERM flips the state machine healthy -> draining: the decode state
  (prompts + generated tokens + position) checkpoints atomically and a
  successor resumes mid-generation (:meth:`Server.resume`),
  bit-identical to an uninterrupted run;
* ``spot_check_every`` reruns a 16 x 16 write on the model's device (the
  write kernel on the card) every that many decode steps, bit-equal to
  its first run (:meth:`Server.check_substrate`);
* exhausted recovery emits a machine-readable
  :class:`~repro_torch.runtime.guard.FailureReport`.

Sampling: greedy at ``temperature == 0`` (the parity mode against the
JAX package), else top-k sampling from a ``torch.Generator`` seeded by
the coordinates.  These streams differ from the JAX package's
``jax.random`` streams.

Serving on a mesh (every rank runs the same server, SPMD over
``torch.distributed``): ``Server(mesh=)`` lays the model out on the
``(data, model)`` mesh (:func:`repro_torch.distributed.sharding.
shard_model`; the ``model`` axis is tensor parallelism,
:mod:`repro_torch.distributed.tensor_parallel`) and registers the mesh
for its decode steps, whose block-space decode kernel shards the slots
over ``data`` (:func:`repro_torch.models.attention.set_decode_mesh`).
``PagedServer`` takes no mesh, as in the JAX package: it serves a model
laid out by the caller and shards its paged decode over the registered
mesh.  Every rank samples the same token from the same logits and key,
so no rank broadcasts; on a mesh only its first rank writes the decode
checkpoints.

Runnable directly:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch quickstart
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged
On a mesh, one process a rank (the ranks share the card over gloo):
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --mesh 2x2 --decode-kernel blockspace
Chaos smoke (deterministic fault injection; see repro_torch.runtime.chaos):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --chaos-seed 7
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import paged as paged_lib
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.distributed.fault_tolerance import PreemptionGuard
from repro_torch.models import ModelConfig, decode_step, prefill
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.runtime.guard import (Backoff, DegradationLadder,
                                       GuardedCall, GuardExhausted,
                                       ServerState, coordinate_seed,
                                       sample_key, spot_check,
                                       validate_finite)


@dataclasses.dataclass
class ServeConfig:
    """The JAX package's ServeConfig, with its defaults."""
    max_len: int = 256
    temperature: float = 0.0       # 0 = greedy
    top_k: int = 40
    seed: int = 0
    eos_id: int = -1               # -1 = never stop early
    # -- robustness ---------------------------------------------------------
    guard: bool = True             # False = bare calls (no retries)
    retries: int = 3
    backoff_base_s: float = 0.05
    deadline_s: Optional[float] = None
    enforce_deadline: bool = False
    # NaN/inf screen on every guarded output (ValidationError, retried);
    # PagedServer also verifies its page table after every change
    validate: bool = True
    spot_check_every: int = 0      # decode steps between substrate canaries
    ckpt_dir: Optional[str] = None  # decode-state checkpoint directory
    ckpt_every: int = 0            # decode steps between checkpoints
    report_dir: Optional[str] = None  # failure reports land here


def _sample_row(logits_row: torch.Tensor, scfg: ServeConfig,
                key: int) -> int:
    """One token from a (V,) logits row: argmax, or top-k sampling from
    a CPU generator seeded by ``key`` (a coordinate seed, see
    :func:`~repro_torch.runtime.guard.sample_key`)."""
    if scfg.temperature <= 0:
        return int(torch.argmax(logits_row))
    scaled = logits_row.detach().to("cpu", torch.float32) / scfg.temperature
    if scfg.top_k:
        kth = torch.topk(scaled, scfg.top_k).values[-1]
        scaled = torch.where(scaled < kth, -1e30, scaled)
    g = torch.Generator().manual_seed(int(key))
    return int(torch.multinomial(torch.softmax(scaled, -1), 1,
                                 generator=g))


def _lay_out(model, mesh) -> None:
    """Lay ``model`` out on ``mesh`` unless it already is (on that mesh);
    raises for a model laid out on another one."""
    from repro_torch.distributed.sharding import shard_model
    have = getattr(model, "mesh", None)
    if have is None:
        shard_model(model, mesh)
    elif have is not mesh:
        raise ValueError("the model is laid out on another mesh than the "
                         "server's")


def _first_rank(mesh) -> bool:
    """Whether this process writes what the ranks of ``mesh`` share."""
    if mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def _check_tokens(cfg: ModelConfig) -> None:
    """Both servers take token prompts (and sample tokens to feed back),
    as in the JAX package: refuse an embedding-input configuration
    before anything runs."""
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"serving takes token prompts; {cfg.name} has input_mode "
            f"{cfg.input_mode!r} (call prefill / decode_step with "
            f"embeddings directly)")


def _build_kernels(device) -> None:
    """On the card, build the kernel libraries the servers launch (the
    attention kernels of prefill and decode, and the write kernel of the
    substrate canary) before any guarded call: a build failure raises
    here instead of walking the ladder."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _cuda
        _cuda.build(("flash_attention", "sierpinski_write"))


class _GuardedServing:
    """What both servers share: the guard around prefill and decode, the
    degradation ladder the decode step walks, failure reports and the
    substrate canary.  A subclass gives ``_rungs`` and ``_apply_rung``
    and calls :meth:`_init_guarding` before building its guarded
    calls."""

    def _init_guarding(self, cfg: ModelConfig, model, chaos) -> None:
        """The guarded calls and the ladder's hook reach the server's
        state through the objects they need (the event list, the ladder,
        the one-slot ``_rung_cfg`` holder of the decode config), never
        through ``self``: a server is not in a reference cycle with its
        guarded calls, so dropping it frees its model at once."""
        self.chaos = chaos
        self.state = ServerState.HEALTHY
        self.events: list = []
        events = self.events
        self.ladder = DegradationLadder(
            self._rungs(cfg),
            on_transition=lambda rec: events.append(
                {"kind": "degrade", **rec}))
        self._canary_ref = None
        _build_kernels(model.device)
        self._rung_cfg: list = [None]
        self._apply_rung(self.ladder.current())

    @property
    def _decode_cfg(self) -> ModelConfig:
        """The config the decode step runs under (the ladder's rung)."""
        return self._rung_cfg[0]

    def _guarded(self, site: str, fn):
        if self.chaos is not None:
            ladder = self.ladder
            fn = self.chaos.wrap(site, fn, rung=lambda: ladder.level)
        if not self.scfg.guard:
            return fn
        validators = []
        if self.scfg.validate:
            validators.append(lambda o, s=site: validate_finite(o, s))
        return GuardedCall(
            fn, site, retries=self.scfg.retries,
            backoff=Backoff(base_s=self.scfg.backoff_base_s,
                            seed=self.scfg.seed),
            deadline_s=self.scfg.deadline_s,
            enforce_deadline=self.scfg.enforce_deadline,
            validators=validators,
            on_event=self.events.append,
            before_retry=(self.chaos.refresh if self.chaos is not None
                          else None))

    def _decode_step(self, *args):
        """One guarded decode step on ``args`` (after the model).  When
        the guard's retries are exhausted, walk the degradation ladder
        (with a warning) and re-execute on the lower rung.  A fatal
        error -- a failed build, a sticky device error, a refused
        argument -- is reported and re-raised on the rung it happened
        on: a lower rung never hides it (the JAX package steps down on
        those too)."""
        while True:
            try:
                return self._decode(self.model, *args)
            except GuardExhausted as e:
                if (e.report.classification != "exhausted"
                        or not self.ladder.step_down(reason=str(e))):
                    e.report.transitions = list(self.ladder.transitions)
                    self._write_report(e.report)
                    raise
                t = self.ladder.transitions[-1]
                warnings.warn(
                    f"serve.decode stepped down from {t['from']} to "
                    f"{t['to']} after: {e}", RuntimeWarning, stacklevel=2)
                self.state = ServerState.DEGRADED
                self._apply_rung(self.ladder.current())

    def _write_report(self, report) -> Optional[str]:
        if not self.scfg.report_dir:
            return None
        path = os.path.join(self.scfg.report_dir,
                            f"failure_{report.name.replace('.', '_')}.json")
        return report.write(path)

    def check_substrate(self) -> None:
        """Spot-check the kernel substrate: rerun a tiny known-good
        block-space write on the model's device (the write kernel on the
        card) and demand a result bit-identical to the first canary's.
        Raises ValidationError on mismatch."""
        from repro_torch.kernels.sierpinski_write import sierpinski_write
        out = sierpinski_write(
            torch.zeros((16, 16), dtype=torch.float32,
                        device=self.model.device), 1.0,
            block=4, grid_mode="closed_form", coarsen=1, num_stages=1)
        if self._canary_ref is None:
            self._canary_ref = out
            return
        spot_check(self._canary_ref, "lambda canary")(out)


class Server(_GuardedServing):
    """Guarded prefill + decode loop over a fixed batch, on the model's
    device, with the serving state machine (healthy -> degraded ->
    draining) and the degradation ladder."""

    def __init__(self, cfg: ModelConfig, model, scfg: ServeConfig,
                 mesh=None, chaos=None):
        _check_tokens(cfg)
        if mesh is not None:
            _lay_out(model, mesh)
        self.cfg, self.model, self.scfg, self.mesh = cfg, model, scfg, mesh
        self._ckpt = None
        if scfg.ckpt_dir:
            from repro_torch.checkpoint.manager import CheckpointManager
            self._ckpt = CheckpointManager(scfg.ckpt_dir, keep=2)
        self._init_guarding(cfg, model, chaos)
        self._prefill = self._guarded(
            "serve.prefill", lambda model, prompts: prefill(
                model, prompts, max_len=scfg.max_len, cfg=cfg))
        rung_cfg = self._rung_cfg
        self._decode = self._guarded(
            "serve.decode", lambda model, tok, cache, pos: decode_step(
                model, tok, cache, pos, rung_cfg[0]))

    # -- degradation ladder --------------------------------------------------

    @staticmethod
    def _rungs(cfg: ModelConfig) -> list:
        """Fallback configs, as-configured first: blockspace decode
        degrades to the plain decode path, an exotic attention lowering
        (compact / prefetch_lut / mma) degrades to the closed form."""
        top = {"decode_kernel": cfg.attn_decode_kernel,
               "grid_lowering": cfg.grid_lowering}
        rungs = [top]
        if cfg.attn_decode_kernel == "blockspace":
            rungs.append({**top, "decode_kernel": "xla"})
        if cfg.grid_lowering in ("compact", "prefetch_lut", "mma"):
            rungs.append({"decode_kernel": "xla",
                          "grid_lowering": "closed_form"})
        return rungs

    def _apply_rung(self, rung: dict) -> None:
        """Run the decode step under this rung's config from now on
        (prefill and the cache layout are rung-independent)."""
        self._rung_cfg[0] = self.cfg.replace(
            attn_decode_kernel=rung["decode_kernel"],
            grid_lowering=rung["grid_lowering"])

    # -- sampling ------------------------------------------------------------

    def _sample(self, logits, pos: int):
        """logits (B,1,V) -> tokens (B,1) int64 on the host.  Keys are a
        pure function of (seed, slot, position): a retried / replayed
        step samples the identical token."""
        if self.scfg.temperature <= 0:
            return torch.argmax(logits[:, 0], dim=-1)[:, None].cpu()
        keys = sample_key(self.scfg.seed, pos, logits.shape[0])
        rows = [_sample_row(logits[i, 0], self.scfg, keys[i])
                for i in range(logits.shape[0])]
        return torch.tensor(rows, dtype=torch.int64)[:, None]

    # -- decode-state checkpointing ------------------------------------------

    def _save_decode_state(self, prompts, out, pos: int,
                           max_new: int) -> None:
        if self._ckpt is None or not _first_rank(self.mesh):
            return
        tokens = torch.cat(out, dim=1).numpy()
        state = {"prompts": np.asarray(prompts, np.int32),
                 "tokens": tokens.astype(np.int32)}
        self._ckpt.save(len(out), state,
                        extra={"pos": int(pos), "max_new": int(max_new),
                               "batch": int(tokens.shape[0]),
                               "prompt_len": int(np.shape(prompts)[1]),
                               "num_tokens": int(tokens.shape[1])})

    # -- generation ----------------------------------------------------------

    def _on_mesh(self):
        """The decode mesh of this server's calls (a no-op off a mesh)."""
        return (attn_lib.decode_mesh(self.mesh) if self.mesh is not None
                else contextlib.nullcontext())

    def generate(self, prompts, max_new: int = 32,
                 on_step=None) -> np.ndarray:
        """prompts: (B, S) int tokens.  Returns the generated (B, T)
        continuation, T = max_new unless every slot hit ``eos_id`` (or a
        preemption drained the server) earlier; finished slots pad with
        ``eos_id``.  ``on_step(pos, logits)``, when given, sees the
        (B, 1, V) logits of every step (prefill, then each decode)
        before sampling."""
        if self.state == ServerState.DRAINING:
            raise RuntimeError("server is draining; start a successor "
                               "and resume() from the decode checkpoint")
        scfg = self.scfg
        dev = self.model.device
        prompts = np.asarray(prompts)
        with PreemptionGuard() as preempt, self._on_mesh():
            logits, cache = self._prefill(
                self.model, torch.as_tensor(prompts, dtype=torch.int64,
                                            device=dev))
            batch, pos = prompts.shape[0], prompts.shape[1] - 1
            if on_step is not None:
                on_step(pos, logits)
            finished = np.zeros((batch,), bool)
            tok, finished = self._next_token(logits, pos, finished)
            out = [tok]
            for i in range(max_new - 1):
                if scfg.eos_id >= 0 and finished.all():
                    break
                if preempt.fired:
                    self._drain(prompts, out, pos, max_new)
                    break
                pos += 1
                logits, cache = self._decode_step(tok.to(dev), cache, pos)
                if on_step is not None:
                    on_step(pos, logits)
                tok, finished = self._next_token(logits, pos, finished)
                out.append(tok)
                if (scfg.spot_check_every
                        and (i + 1) % scfg.spot_check_every == 0):
                    self.check_substrate()
                if scfg.ckpt_every and len(out) % scfg.ckpt_every == 0:
                    self._save_decode_state(prompts, out, pos, max_new)
            else:
                if preempt.fired:
                    self._drain(prompts, out, pos, max_new)
        return torch.cat(out, dim=1).numpy()

    def _next_token(self, logits, pos: int, finished: np.ndarray):
        """Sample, then overwrite finished slots with the EOS pad and
        fold newly-finished slots into the mask."""
        tok = self._sample(logits, pos)
        if self.scfg.eos_id < 0:
            return tok, finished
        t = tok.numpy()
        t = np.where(finished[:, None], self.scfg.eos_id, t)
        finished = finished | (t[:, 0] == self.scfg.eos_id)
        return torch.from_numpy(t), finished

    def _drain(self, prompts, out, pos: int, max_new: int) -> None:
        self.state = ServerState.DRAINING
        self.events.append({"kind": "drain", "pos": int(pos),
                            "tokens": len(out), "time": time.time()})
        self._save_decode_state(prompts, out, pos, max_new)

    # -- resume --------------------------------------------------------------

    def resume(self) -> np.ndarray:
        """Resume a drained/preempted generation from the decode-state
        checkpoint (either package's): replay the saved tokens through
        prefill + decode to rebuild the caches (KV and SSM states;
        feeding the *saved* token at each replayed position -- no
        re-sampling, no drift), then keep sampling with the same (seed, slot, position) keys.
        The full returned stream is bit-identical to an uninterrupted
        run."""
        if self._ckpt is None:
            raise RuntimeError("resume() needs ServeConfig.ckpt_dir")
        meta = self._ckpt.read_meta()
        e = meta["extra"]
        template = {
            "prompts": np.zeros((e["batch"], e["prompt_len"]), np.int32),
            "tokens": np.zeros((e["batch"], e["num_tokens"]), np.int32)}
        _, state, _, _ = self._ckpt.restore(meta["step"], template)
        prompts, saved = state["prompts"], state["tokens"].astype(np.int64)
        max_new = e["max_new"]
        dev = self.model.device
        with self._on_mesh():
            logits, cache = self._prefill(
                self.model, torch.as_tensor(prompts, dtype=torch.int64,
                                            device=dev))
            pos = prompts.shape[1] - 1
            finished = np.zeros((prompts.shape[0],), bool)
            tok = torch.from_numpy(saved[:, 0:1])
            out = [tok]
            for i in range(1, saved.shape[1]):
                pos += 1
                logits, cache = self._decode_step(tok.to(dev), cache, pos)
                tok = torch.from_numpy(saved[:, i:i + 1])
                out.append(tok)
            if self.scfg.eos_id >= 0:
                finished = (saved == self.scfg.eos_id).any(axis=1)
            for _ in range(saved.shape[1], max_new):
                if self.scfg.eos_id >= 0 and finished.all():
                    break
                pos += 1
                logits, cache = self._decode_step(tok.to(dev), cache, pos)
                tok, finished = self._next_token(logits, pos, finished)
                out.append(tok)
        self.state = ServerState.HEALTHY
        self.events.append({"kind": "resume", "replayed": saved.shape[1],
                            "total": len(out), "time": time.time()})
        return torch.cat(out, dim=1).numpy()


# ---------------------------------------------------------------------------
# paged continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedServeConfig(ServeConfig):
    """ServeConfig plus the paged-pool knobs.  ``num_pages`` includes
    the reserved null page, so usable capacity is ``(num_pages - 1) *
    page_size`` tokens across all slots; ``max_len`` bounds one
    request's prompt + generation (it sizes the page table width)."""
    num_slots: int = 4
    page_size: int = 16
    num_pages: int = 64


@dataclasses.dataclass
class _PagedRequest:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    pages: list = dataclasses.field(default_factory=list)
    next_pos: int = 0       # where the next fed token's KV lands
    seq: int = -1           # admission order (eviction priority)
    preemptions: int = 0


class PagedServer(_GuardedServing):
    """Continuous-batching serving over the paged KV pool.

    The decode batch is a fixed set of ``num_slots`` slots; requests
    stream through them.  Admission runs an unpadded prefill for one
    request, allocates ``ceil(len / page_size)`` pages from the free
    list and scatters the prefill KV into them; every decode step
    advances all active slots one token at their own positions (the
    per-slot ``seq_pos`` vector) while inactive slots write to the null
    page.  Pages are allocated as slots cross page boundaries; when the
    pool runs dry the youngest active request is preempted -- its pages
    freed, the request requeued with its generated tokens kept, to be
    re-admitted by replaying prompt + generated through prefill.

    Prefill and decode run guarded like :class:`Server`'s; repeated
    decode failure walks the ladder paged-blockspace -> paged-xla (the
    plain gather decode), switching the step's config as
    :meth:`Server._apply_rung` does.

    It takes no mesh (the JAX package's does not): a model the caller
    laid out on a mesh serves tensor-parallel, each rank's pools holding
    its KV heads, and the paged decode kernel shards the slots over the
    mesh registered with :func:`~repro_torch.models.attention.
    set_decode_mesh`."""

    def __init__(self, cfg: ModelConfig, model, scfg: PagedServeConfig,
                 chaos=None):
        model_lib._check_paged(cfg)
        _check_tokens(cfg)
        self.cfg, self.model, self.scfg = cfg, model, scfg
        self.mesh = None
        self.stats_history: list = []
        self.alloc = paged_lib.PagedKVPool(scfg.num_pages, scfg.page_size)
        self.max_pages = -(-scfg.max_len // scfg.page_size)
        # a tensor-parallel rank's pools hold its KV heads
        self.pools = model_lib.init_paged_cache(
            cfg, scfg.num_pages, scfg.page_size, model.device,
            kv_heads=tp_lib.kv_heads(model.layers[0].mixer, cfg))
        self.table = np.full((scfg.num_slots, self.max_pages),
                             paged_lib.NULL_PAGE, np.int32)
        self.slots: list = [None] * scfg.num_slots
        self.pending: collections.deque = collections.deque()
        self.done: dict = {}
        self._admit_seq = 0
        #: decode steps run, and host seconds spent in them (the decode
        #: call through the sampled tokens on the host)
        self.decode_steps = 0
        self.step_seconds = 0.0
        self._init_guarding(cfg, model, chaos)
        self._prefill = self._guarded(
            "serve.prefill",
            lambda model, tokens: prefill(model, tokens, cfg=cfg))
        rung_cfg = self._rung_cfg
        self._decode = self._guarded(
            "serve.decode",
            lambda model, toks, pools, table, posv, act:
            model_lib.decode_step_paged(model, toks, pools, table, posv,
                                        act, rung_cfg[0]))

    @staticmethod
    def _rungs(cfg: ModelConfig) -> list:
        top = {"decode_kernel": cfg.attn_decode_kernel}
        rungs = [top]
        if cfg.attn_decode_kernel == "blockspace":
            rungs.append({"decode_kernel": "xla"})  # paged-xla gather
        return rungs

    def _apply_rung(self, rung: dict) -> None:
        self._rung_cfg[0] = self.cfg.replace(
            attn_decode_kernel=rung["decode_kernel"])

    # -- host bookkeeping ----------------------------------------------------

    def _verify_table(self) -> None:
        if not self.scfg.validate:
            return
        from repro_torch.analysis.verifier import verify_page_table
        verify_page_table(
            self.table,
            seq_lens=[(r.next_pos if r is not None else 0)
                      for r in self.slots],
            page_size=self.scfg.page_size,
            num_pages=self.scfg.num_pages,
            free_pages=self.alloc._free)

    def pool_stats(self) -> dict:
        return self.alloc.stats(
            [r.next_pos for r in self.slots if r is not None])

    # -- request lifecycle ---------------------------------------------------

    def submit(self, rid: int, prompt, max_new: int) -> None:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new > self.scfg.max_len:
            raise ValueError(
                f"request {rid}: prompt {len(prompt)} + max_new "
                f"{max_new} exceeds max_len {self.scfg.max_len}")
        self.pending.append(_PagedRequest(
            rid=int(rid), prompt=prompt, max_new=int(max_new)))

    def _sample_token(self, logits_row, rid: int, pos: int) -> int:
        """One token from a (V,) logits row, keyed on (seed, request id,
        position): a preempted and re-admitted request draws the
        identical stream."""
        return _sample_row(logits_row, self.scfg,
                           coordinate_seed(self.scfg.seed, rid, pos))

    def _admit_one(self) -> bool:
        """Admit the head-of-line request if a slot and enough pages
        are free.  Returns True on admission."""
        if not self.pending:
            return False
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return False
        req = self.pending[0]
        tokens = np.concatenate(
            [req.prompt, np.asarray(req.out, np.int32)])
        need = paged_lib.pages_for(len(tokens), self.scfg.page_size)
        if not self.alloc.can_alloc(need):
            return False
        self.pending.popleft()
        pages = self.alloc.alloc(need)
        slot = free_slots[0]
        dev = self.model.device
        logits, caches = self._prefill(
            self.model, torch.as_tensor(tokens[None], dtype=torch.int64,
                                        device=dev))
        model_lib.scatter_prefill_pages(
            self.pools, caches, torch.as_tensor(pages, device=dev),
            self.cfg)
        req.pages = list(pages)
        req.seq = self._admit_seq
        self._admit_seq += 1
        req.next_pos = len(tokens)
        self.table[slot] = paged_lib.NULL_PAGE
        self.table[slot, :len(pages)] = pages
        self.slots[slot] = req
        self._verify_table()
        tok = self._sample_token(logits[0, 0], req.rid, len(tokens) - 1)
        req.out.append(tok)
        if self._finished(slot, tok):
            return True
        self.events.append({"kind": "admit", "rid": req.rid,
                            "slot": slot, "pages": len(pages),
                            "replayed": len(req.out) - 1})
        return True

    def _finished(self, slot: int, tok: int) -> bool:
        req = self.slots[slot]
        if len(req.out) >= req.max_new or (
                self.scfg.eos_id >= 0 and tok == self.scfg.eos_id):
            self.alloc.free(req.pages)
            self.table[slot] = paged_lib.NULL_PAGE
            self.slots[slot] = None
            self.done[req.rid] = np.asarray(req.out, np.int32)
            self.events.append({"kind": "finish", "rid": req.rid,
                                "tokens": len(req.out),
                                "preemptions": req.preemptions})
            self._verify_table()
            return True
        return False

    def _preempt(self, slot: int) -> None:
        req = self.slots[slot]
        self.alloc.free(req.pages)
        req.pages = []
        req.preemptions += 1
        self.table[slot] = paged_lib.NULL_PAGE
        self.slots[slot] = None
        self.pending.appendleft(req)  # re-admit first
        self.events.append({"kind": "preempt", "rid": req.rid,
                            "slot": slot, "generated": len(req.out)})
        # no _verify_table here: surviving slots may already hold the
        # look-ahead page grown for this step's write, which the verifier
        # would flag as tail-null until next_pos advances; step()
        # verifies once the step is quiescent.

    def _grow(self, slot: int) -> bool:
        """Ensure the slot owns the page its next KV write lands in."""
        req = self.slots[slot]
        while req.next_pos // self.scfg.page_size >= len(req.pages):
            got = self.alloc.alloc(1)
            if got is None:
                return False
            self.table[slot, len(req.pages)] = got[0]
            req.pages += got
        return True

    def step(self) -> bool:
        """One decode step for every active slot.  Returns False when
        nothing is active."""
        active = [i for i in range(len(self.slots))
                  if self.slots[i] is not None]
        if not active:
            return False
        # on-demand page growth, oldest slots first; preempt the
        # youngest active request until the survivors fit
        for i in sorted(active, key=lambda j: self.slots[j].seq):
            while self.slots[i] is not None and not self._grow(i):
                victims = [j for j in range(len(self.slots))
                           if self.slots[j] is not None]
                victim = max(victims, key=lambda j: self.slots[j].seq)
                if victim == i and len(victims) == 1:
                    raise RuntimeError(
                        f"pool of {self.scfg.num_pages} pages cannot "
                        f"hold a single request; raise num_pages or "
                        f"page_size")
                self._preempt(victim)
        active = [i for i in range(len(self.slots))
                  if self.slots[i] is not None]
        if not active:
            return False
        B = self.scfg.num_slots
        toks = np.zeros((B, 1), np.int64)
        posv = np.zeros((B,), np.int32)
        act = np.zeros((B,), bool)
        for i in active:
            req = self.slots[i]
            toks[i, 0] = req.out[-1]
            posv[i] = req.next_pos
            act[i] = True
        dev = self.model.device
        t0 = time.perf_counter()
        logits, self.pools = self._decode_step(
            torch.from_numpy(toks).to(dev), self.pools,
            torch.from_numpy(self.table).to(dev),
            torch.from_numpy(posv).to(dev), torch.from_numpy(act).to(dev))
        self.decode_steps += 1
        if self.scfg.temperature <= 0:
            # one device-to-host copy of the argmaxes for all slots
            greedy = torch.argmax(logits[:, 0], dim=-1).cpu().tolist()
        # advance every slot before any finish check: the decode step
        # already wrote position next_pos for all of them
        sampled = []
        for i in active:
            req = self.slots[i]
            tok = greedy[i] if self.scfg.temperature <= 0 else \
                self._sample_token(logits[i, 0], req.rid, req.next_pos)
            req.next_pos += 1
            req.out.append(tok)
            sampled.append((i, tok))
        self.step_seconds += time.perf_counter() - t0
        for i, tok in sampled:
            self._finished(i, tok)
        self._verify_table()
        self.stats_history.append(self.pool_stats())
        return True

    def run(self, requests, max_new: int = 32) -> dict:
        """Serve ``requests`` (a list of 1-D prompt token arrays) to
        completion.  Returns {rid: generated np.int32 array}."""
        for rid, prompt in enumerate(requests):
            self.submit(rid, prompt, max_new)
        while self.pending or any(s is not None for s in self.slots):
            while self._admit_one():
                pass
            if not self.step() and self.pending:
                raise RuntimeError(
                    "no active slots and the head-of-line request "
                    "cannot be admitted; pool too small")
        return self.done


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def paged_throughput_report(server: PagedServer, requests,
                            max_new: int = 16) -> dict:
    """Serve ``requests`` and report host-clock throughput (the clock
    stops after the device finishes)."""
    steps0, secs0 = server.decode_steps, server.step_seconds
    t0 = time.perf_counter()
    out = server.run(requests, max_new=max_new)
    _sync(server.model.device)
    dt = time.perf_counter() - t0
    tokens = int(sum(len(v) for v in out.values()))
    frag = [s["fragmentation"] for s in server.stats_history] or [0.0]
    util = [s["utilization"] for s in server.stats_history] or [0.0]
    return {"tokens": tokens, "seconds": dt, "tok_per_s": tokens / dt,
            "requests": len(out),
            "decode_steps": server.decode_steps - steps0,
            "ms_per_decode_step": 1e3 * (server.step_seconds - secs0)
            / max(1, server.decode_steps - steps0),
            "preemptions": sum(1 for e in server.events
                               if isinstance(e, dict)
                               and e.get("kind") == "preempt"),
            "mean_fragmentation": float(np.mean(frag)),
            "mean_utilization": float(np.mean(util)),
            "peak_utilization": float(np.max(util))}


def throughput_report(server: Server, batch: int, prompt_len: int,
                      max_new: int = 16):
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, server.cfg.vocab_size, (batch, prompt_len))
    t0 = time.perf_counter()
    out = server.generate(prompts, max_new=max_new)
    _sync(server.model.device)
    dt = time.perf_counter() - t0
    return {"tokens": int(out.size), "seconds": dt,
            "tok_per_s": out.size / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="quickstart")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a slot early when it samples this token "
                         "(-1 = never)")
    ap.add_argument("--retries", type=int, default=3,
                    help="guarded-call retry budget per step")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-call deadline in seconds (recorded; "
                         "enforcement via ServeConfig)")
    ap.add_argument("--ckpt-dir", default="",
                    help="decode-state checkpoint directory (enables "
                         "preemption-safe draining + resume)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="serve under deterministic randomized fault "
                         "injection (repro_torch.runtime.chaos) with "
                         "this seed")
    ap.add_argument("--grid-lowering", default="",
                    choices=("", "closed_form", "prefetch_lut", "bounding",
                             "mma", "compact"),
                    help="GridPlan lowering of the prefill's attention "
                         "schedule and of the blockspace decode kernels "
                         "(default: the arch's attn_schedule)")
    ap.add_argument("--decode-kernel", default="",
                    choices=("", "xla", "blockspace"),
                    help="decode attention: 'blockspace' runs the flash "
                         "kernel with the run-time seq_pos block skip, "
                         "'xla' the plain masked decode (default: the "
                         "arch's setting, normally 'xla')")
    ap.add_argument("--mesh", default="",
                    help="serve on a mesh of the ranks this command runs "
                         "as (python -m torch.distributed.run "
                         "--nproc-per-node N ...): 'host' (every rank, "
                         "tp=1) or 'DATAxMODEL' (e.g. '2x2').  The model "
                         "axis is tensor parallelism; the blockspace "
                         "decode kernels shard the slots over 'data'")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV pool + continuous-"
                         "batching scheduler (PagedServer); --batch "
                         "becomes the request count and prompts get "
                         "mixed lengths in [4, --prompt-len]")
    ap.add_argument("--num-slots", type=int, default=4,
                    help="paged: concurrently decoding slots")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged: tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="paged: physical pages in the pool incl. the "
                         "reserved null page (0 = enough for num_slots "
                         "requests at max_len)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    dev = backend_lib.default_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    if args.grid_lowering:
        cfg = cfg.replace(grid_lowering=args.grid_lowering)
        print(f"grid lowering: {cfg.grid_mode} "
              f"(schedule: {cfg.attn_schedule_resolved})")
    if args.decode_kernel:
        cfg = cfg.replace(attn_decode_kernel=args.decode_kernel)
        print(f"decode attention: {cfg.attn_decode_kernel}")
    mesh = None
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_device, resolve_cli_mesh
        if not dist.is_initialized():
            dist.init_process_group("gloo")  # the launcher's environment
        mesh = resolve_cli_mesh(args.mesh, device=dev.type)
        dev = mesh_device(mesh)
    if cfg.attn_decode_kernel == "blockspace":
        attn_lib.set_decode_mesh(mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = model_lib.init(cfg, gen, dev)
    print(f"device: {dev} ({backend_lib.resolve(dev).name} target)")
    if mesh is not None:
        from repro_torch.distributed.sharding import shard_model
        shard_model(model, mesh)
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}, rank "
              f"{dist.get_rank()} of {dist.get_world_size()} (the model "
              f"axis tensor-parallel, the decode kernels' slots over "
              f"'data')")
    chaos = None
    if args.chaos_seed is not None:
        from repro_torch.runtime.chaos import ChaosInjector, FaultPlan
        plan = FaultPlan.from_seed(
            args.chaos_seed, sites=("serve.prefill", "serve.decode"),
            horizon=args.max_new)
        chaos = ChaosInjector(plan)
        print(f"chaos: {len(plan.faults)} faults scheduled "
              f"(seed {plan.seed})")
    if args.paged:
        max_len = args.prompt_len + args.max_new
        num_pages = args.num_pages or (
            1 + args.num_slots * paged_lib.pages_for(max_len,
                                                     args.page_size))
        server = PagedServer(cfg, model, PagedServeConfig(
            max_len=max_len, temperature=args.temperature,
            eos_id=args.eos_id, retries=args.retries,
            deadline_s=args.deadline, num_slots=args.num_slots,
            page_size=args.page_size, num_pages=num_pages), chaos=chaos)
        rng = np.random.default_rng(0)
        requests = [rng.integers(0, cfg.vocab_size,
                                 (int(rng.integers(4, args.prompt_len
                                                   + 1)),))
                    for _ in range(args.batch)]
        print(f"paged: {args.num_slots} slots, {num_pages} pages of "
              f"{args.page_size} tokens, {args.batch} mixed-length "
              f"requests")
        rep = paged_throughput_report(server, requests,
                                      max_new=args.max_new)
        if chaos is not None:
            print(f"chaos: {len(chaos.events)} faults fired, "
                  f"state {server.state.value}")
        print(rep)
        return
    server = Server(cfg, model, ServeConfig(
        max_len=args.prompt_len + args.max_new,
        temperature=args.temperature, eos_id=args.eos_id,
        retries=args.retries, deadline_s=args.deadline,
        ckpt_dir=args.ckpt_dir or None,
        ckpt_every=4 if args.ckpt_dir else 0), mesh=mesh, chaos=chaos)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len))
    out = server.generate(prompts, max_new=args.max_new)
    print("generated shape:", out.shape)
    if chaos is not None:
        recov = sum(getattr(g, "recoveries", 0)
                    for g in (server._prefill, server._decode))
        print(f"chaos: {len(chaos.events)} faults fired, "
              f"{recov} recoveries, state {server.state.value}")
        if (out < 0).any():
            raise SystemExit("chaos smoke: corrupted output escaped")
    print(throughput_report(server, args.batch, args.prompt_len,
                            args.max_new))


if __name__ == "__main__":
    main()
