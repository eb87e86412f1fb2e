"""SFT trainer: AdamW + grad accumulation + freeze / LoRA regimes, the
counterpart of ``molly_tpu/training/trainer.py`` on one device.

Feature map:
  - freeze switches train_bio / train_mlp / train_llm -> a boolean
    trainable mask over the top-level subtrees; only trainable leaves
    require grad, so no backward exists for a frozen subtree (frozen
    encoders run under ``torch.no_grad()``)
  - LoRA regime -> ``models.lora`` adapters trained alongside projectors,
    base params all frozen; QLoRA = the same over an int8 base
  - the optimizer is the optax chain of the JAX package written out:
    clip by global norm, Adam with bias correction, decayed weights, the
    warmup + cosine / linear / constant schedule at the optimizer's count —
    every step in the parameter's dtype, as optax keeps it
  - grad accumulation: a Python loop over microbatches, each microbatch's
    loss normalised by its own tokens, gradients averaged
  - an MoE decoder adds ``router_aux_coef * load_balance`` to the loss and
    reports ``moe_load_balance`` (1.0 = balanced routing), averaged over
    the microbatches
  - the non-finite guard keeps the old state when the loss or the gradient
    norm is not finite

Parameters and moments are updated IN PLACE (JAX returns a new state): the
state a step returns shares its tensors with the one it was given. The
mesh branches and pipeline microbatching (``pp_micro``) belong to the
multi-device slice and are refused; ``offload_opt_state`` (a one-device
option: the moments live in host memory between steps) is not ported yet
and is refused too.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from ..models import fusion, lora as lora_lib, qwen3
from ..models.configs import FusionConfig
from ..models.lora import LoraConfig
from ..utils.tree import leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    min_lr_ratio: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    accum_steps: int = 1
    # freeze switches (reference --train-bio/--train-mlp/--train-llm)
    train_bio: bool = False
    train_mlp: bool = True
    train_llm: bool = True
    # LoRA regime: when set, base LLM is frozen and adapters train
    lora: Optional[LoraConfig] = None
    z_loss: float = 0.0
    # chunked linear+CE (ops.lce) instead of [B,S,V] logits
    fused_lce: bool = True
    lce_chunk: int = 256  # tokens per LCE chunk ([C, V] logit peak)
    # options of the JAX package that are refused here: pipeline
    # microbatching (multi-device) and the host-resident optimizer state
    pp_micro: int = 0
    offload_opt_state: bool = False


def trainable_mask(params: Dict[str, Any], cfg: TrainConfig) -> Dict[str, Any]:
    """Boolean tree: which leaves receive updates."""
    def mask_for(top_key: str) -> bool:
        if top_key in ("dna_rna", "protein"):
            return cfg.train_bio
        if top_key.endswith("_projector"):
            return cfg.train_mlp
        if top_key == "text":
            return cfg.train_llm and cfg.lora is None
        return True

    return {k: tree_map(lambda _: mask_for(k), v) for k, v in params.items()}


def _trainable_leaves(params, cfg: TrainConfig) -> List[torch.Tensor]:
    """Trainable floating-point leaves in tree order (an int8 base never
    trains: it only exists under LoRA, which freezes the text tower)."""
    mask = trainable_mask(params, cfg)
    return [t for k in params for t, m in zip(leaves(params[k]),
                                              leaves(mask[k])) if m]


def trainable_paths(params, cfg: TrainConfig) -> List[str]:
    """'/'-joined tree paths of the trainable leaves, in the order of
    ``_trainable_leaves`` (the order of gradients and moments)."""
    def paths(prefix, tree):
        if isinstance(tree, dict):
            return [p for k, v in tree.items()
                    for p in paths(f"{prefix}/{k}", v)]
        return [prefix]

    mask = trainable_mask(params, cfg)
    return [p for k in params for p, m in zip(paths(k, params[k]),
                                              leaves(mask[k])) if m]


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate: linear warmup joined to a cosine / linear
    decay or a constant, with optax's edge cases (a zero-length warmup is
    skipped; the decay counts from the end of the warmup)."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 0)
    peak, floor = cfg.learning_rate, cfg.learning_rate * cfg.min_lr_ratio
    decay_steps = max(cfg.total_steps - warmup, 1)

    def linear(init, end, steps, count):
        if steps <= 0:
            return init
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) + end

    def after(count):
        if cfg.schedule == "constant":
            return peak
        if cfg.schedule == "linear":
            return linear(peak, floor, decay_steps, count)
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return peak * ((1 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup:
            return linear(0.0, peak, warmup, step)
        return after(step - warmup)

    return schedule


@dataclass
class TrainState:
    params: Dict[str, Any]
    # {"mu": [...], "nu": [...]} moments of the trainable leaves in tree
    # order, and "count", the optimizer's own step count (it does not
    # advance on a skipped step)
    opt_state: Dict[str, Any]
    step: int


def _refuse_multi_device(cfg: TrainConfig) -> None:
    if cfg.pp_micro:
        raise NotImplementedError(
            "pp_micro (pipeline parallelism) is not ported: ROADMAP.md "
            "queue 1 item 11")
    if cfg.offload_opt_state:
        raise NotImplementedError(
            "offload_opt_state (optimizer moments in host memory, a "
            "one-device option) is not ported: ROADMAP.md queue 1 item 8")


def init_train_state(params: Dict[str, Any], cfg: TrainConfig) -> TrainState:
    """Zero moments in each trainable leaf's dtype; marks the trainable
    leaves as requiring grad (and no other)."""
    _refuse_multi_device(cfg)
    train = _trainable_leaves(params, cfg)
    train_ids = {id(t) for t in train}
    for k in params:
        for t in leaves(params[k]):
            if t.is_floating_point():
                t.requires_grad_(id(t) in train_ids)
    return TrainState(
        params=params,
        opt_state={"mu": [torch.zeros_like(t) for t in train],
                   "nu": [torch.zeros_like(t) for t in train],
                   "count": 0},
        step=0)


def _split_accum(batch: Dict[str, torch.Tensor], accum: int):
    """[B, ...] -> accum microbatches of [B/accum, ...]."""
    def r(x):
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the summed squares over all leaves, accumulated in fp32."""
    if not grads:
        return torch.zeros(())
    total = sum(g.to(torch.float32).square().sum() for g in grads)
    return torch.sqrt(total)


@torch.no_grad()
def apply_optimizer(train: List[torch.Tensor], grads: List[torch.Tensor],
                    opt_state: Dict[str, Any], cfg: TrainConfig,
                    gnorm: torch.Tensor) -> None:
    """One update of the optax chain ``clip_by_global_norm ->
    scale_by_adam -> add_decayed_weights -> scale_by_learning_rate``, in
    place on ``train`` and the moments, each operation in the leaf's dtype
    and in optax's order of operations."""
    count_inc = opt_state["count"] + 1
    lr = make_schedule(cfg)(opt_state["count"])
    clip = bool(cfg.grad_clip) and not bool(gnorm < cfg.grad_clip)
    bc1 = 1 - cfg.b1 ** count_inc
    bc2 = 1 - cfg.b2 ** count_inc
    for p, g, mu, nu in zip(train, grads, opt_state["mu"], opt_state["nu"]):
        g = g.to(p.dtype)
        if clip:
            g = (g / gnorm.to(g.dtype)) * cfg.grad_clip
        mu.copy_((1 - cfg.b1) * g + cfg.b1 * mu)
        nu.copy_((1 - cfg.b2) * (g * g) + cfg.b2 * nu)
        bc1_t = torch.tensor(bc1, dtype=torch.float32).to(p.dtype)
        bc2_t = torch.tensor(bc2, dtype=torch.float32).to(p.dtype)
        u = (mu / bc1_t) / (torch.sqrt(nu / bc2_t) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p
        u = torch.tensor(-lr, dtype=p.dtype) * u
        p.add_(u)
    opt_state["count"] = count_inc


class _PhaseClock:
    """Seconds per phase of a step for ``stats``: CUDA events between the
    marks on a card (device time, read after one synchronize at the end of
    the step), the host clock on the CPU. Only made when a caller asks for
    timings."""

    def __init__(self, stats: Dict[str, float], device: torch.device):
        self.stats, self.cuda = stats, device.type == "cuda"
        self.marks: List[Tuple[str, Any]] = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def finish(self) -> None:
        if self.cuda:
            self.marks[-1][1].synchronize()
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            self.stats[name + "_s"] = self.stats.get(name + "_s", 0.0) + dt
        self.marks = self.marks[-1:]


def make_grad_fn(model_cfg: FusionConfig, train_cfg: TrainConfig,
                 clock_of: Optional[Callable[[], Optional[_PhaseClock]]] = None):
    """Returns (params, batch, generator) -> (grads, metrics): the loss's
    gradients wrt the trainable leaves (a list in tree order, see
    ``_trainable_leaves``) with the microbatch loop, and the metrics summed
    as the JAX step sums them.

    The loss is differentiated ONLY wrt the trainable leaves: frozen leaves
    do not require grad, so their backward passes never run — with frozen
    encoders the whole encoder backward disappears, and under LoRA the
    base-weight gradient products do."""
    _refuse_multi_device(train_cfg)
    lora_cfg = train_cfg.lora

    def loss_fn(params, batch, generator):
        embeds = fusion.build_inputs_embeds(params, model_cfg, batch)
        hidden, aux_out = qwen3.forward_hidden(
            params["text"], model_cfg.text, inputs_embeds=embeds,
            attention_mask=batch.get("attention_mask"),
            lora=params.get("lora"),
            lora_scale=lora_cfg.scale if lora_cfg else 1.0,
            lora_dropout=lora_cfg.dropout if lora_cfg else 0.0,
            generator=generator if (lora_cfg and lora_cfg.dropout > 0)
            else None)
        loss, metrics = fusion.loss_from_hidden(
            params, model_cfg, hidden, batch, z_loss=train_cfg.z_loss,
            fused_lce=train_cfg.fused_lce, chunk_size=train_cfg.lce_chunk,
            # frozen head (LoRA or --train-llm false): the lm-head /
            # tied-embed weight gradient is dead — skip its matmul
            lce_need_dw=(train_cfg.lora is None and train_cfg.train_llm))
        if model_cfg.text.num_experts and aux_out is not None:
            # MoE router load-balance aux loss (ops.moe), with the HF
            # Qwen3-MoE config's coefficient (router_aux_loss_coef)
            lb = aux_out["moe_aux"]["load_balance"]
            loss = loss + model_cfg.text.router_aux_coef * lb
            metrics = {**metrics, "moe_load_balance": lb}
        return loss, metrics

    def grads_of(params, train, batch, generator):
        clock = clock_of() if clock_of is not None else None
        with torch.enable_grad():
            with record_function("molly/forward"):
                loss, metrics = loss_fn(params, batch, generator)
            if clock:
                clock.mark("forward")
            with record_function("molly/backward"):
                grads = torch.autograd.grad(loss, train, allow_unused=True)
            if clock:
                clock.mark("backward")
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, train)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def grad_fn(params, batch, generator=None):
        accum = train_cfg.accum_steps
        train = _trainable_leaves(params, train_cfg)
        if accum <= 1:
            return grads_of(params, train, batch, generator)
        grads, metrics = None, None
        for mb in _split_accum(batch, accum):
            g, m = grads_of(params, train, mb, generator)
            if grads is None:
                grads, metrics = g, dict(m)
            else:
                grads = [a.add_(b) for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
        for mk in ("loss", "moe_load_balance"):
            if mk in metrics:
                metrics[mk] = metrics[mk] / accum
        return [g / accum for g in grads], metrics

    return grad_fn


def make_train_step(model_cfg: FusionConfig, train_cfg: TrainConfig,
                    stats: Optional[Dict[str, float]] = None):
    """Returns (state, batch, generator) -> (state, metrics). ``batch`` holds
    tensors on the params' device; ``generator`` (on that device) feeds the
    LoRA dropout and may be None when there is none. ``stats``, when given,
    accumulates seconds per phase over the steps (``forward_s``,
    ``backward_s``, ``optimizer_s``; device time on a card)."""
    clock: List[Optional[_PhaseClock]] = [None]
    grad_fn = make_grad_fn(model_cfg, train_cfg, lambda: clock[0])
    schedule = make_schedule(train_cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        if stats is not None:
            clock[0] = _PhaseClock(stats,
                                   state.params["text"]["embed"].device)
        grads, metrics = grad_fn(state.params, batch, generator)
        # grad norm over the params being optimized (also what the clip
        # inside the optimizer sees)
        gnorm = global_norm(grads)
        # NaN/Inf guard: skip the update, keep the old state
        ok = bool(torch.isfinite(metrics["loss"])
                  & torch.isfinite(gnorm).to(metrics["loss"].device))
        if ok:
            with record_function("molly/optimizer"):
                apply_optimizer(_trainable_leaves(state.params, train_cfg),
                                grads, state.opt_state, train_cfg, gnorm)
        if clock[0] is not None:
            clock[0].mark("optimizer")  # with the norm and the guard's sync
            clock[0].finish()
        metrics = {**metrics, "grad_norm": gnorm, "skipped": not ok,
                   "learning_rate": schedule(state.step)}
        return TrainState(params=state.params, opt_state=state.opt_state,
                          step=state.step + 1), metrics

    return train_step


def attach_lora(params: Dict[str, Any], model_cfg: FusionConfig,
                lora_cfg: LoraConfig, generator: torch.Generator,
                dtype=torch.float32) -> Dict[str, Any]:
    """Add a fresh adapter tree to a fusion param tree (LoRA regime), on
    the device of the text embedding (``generator`` lives there)."""
    device = params["text"]["embed"].device
    return {**params,
            "lora": lora_lib.init_lora(model_cfg.text, lora_cfg, generator,
                                       dtype, device)}
