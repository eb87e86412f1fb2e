"""SFT trainer: AdamW + grad accumulation + freeze / LoRA regimes, the
counterpart of ``molly_tpu/training/trainer.py``.

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
    the microbatches, and under expert parallelism ``moe_ep_dropped_frac``
  - the non-finite guard keeps the old state when the loss or the gradient
    norm is not finite

Parameters and moments are updated IN PLACE (JAX returns a new state): the
state a step returns shares its tensors with the one it was given.

Under a mesh (``parallel.use_mesh``, params from ``parallel.shard_params``)
each rank holds its block of every leaf and its own moments (ZeRO-3 over
``fsdp``); its batch is its rows of the global batch. The loss is this
rank's share of the global mean (``fusion.loss_from_hidden``), the
gradients are summed over the batch axes each block is replicated on
(``sharding.sync_grads``), and the norm and the clip count every distinct
block once (``sharding.global_norm``), so the step computes what the JAX
step computes under GSPMD. With ``cfg.text.context_parallel`` on a ``seq``
axis the step lays the sequence out once (``_seq_layout``: labels shifted
first, the zigzag order when asked, this rank's part); with ``pp_micro``
the decoder runs the GPipe loop of ``parallel.pipeline``.

Optimizer offload (``offload_opt_state``, DeepSpeed's optimizer CPU
offload): the Adam moments live in pinned host memory between steps
(``host_opt_shardings`` / ``offload_opt_state``) and ``make_offloaded_step``
streams them through the card in chunks during the update
(``_MomentStream``): the same kernels on the same data, so the update is
bit-equal to the on-device one.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..data.omics_dataset import LABEL_IGNORE
from ..models import fusion, lora as lora_lib, qwen3
from ..models.configs import FusionConfig
from ..models.lora import LoraConfig
from ..parallel import comm, sharding
from ..utils import profiling
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
    # pipeline parallelism: microbatch count for the GPipe clock loop over a
    # "pipe" mesh axis (parallel.pipeline); 0 = off. LoRA not supported in
    # the pipelined decoder path.
    pp_micro: int = 0
    # Adam moments in (pinned) host memory between steps: see
    # offload_opt_state / make_offloaded_step
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


def init_train_state(params: Dict[str, Any], cfg: TrainConfig) -> TrainState:
    """Zero moments in each trainable leaf's dtype; marks the trainable
    leaves as requiring grad (and no other). With ``cfg.offload_opt_state``
    the moments are made where ``host_opt_shardings`` places them (pinned
    host memory for params on a card), never on the card: at depths where
    offload matters they would not fit there. Under a mesh each rank
    passes its blocks and makes the moments of its blocks."""
    train = _trainable_leaves(params, cfg)
    train_ids = {id(t) for t in train}
    for k in params:
        for t in leaves(params[k]):
            if t.is_floating_point():
                t.requires_grad_(id(t) in train_ids)

    def zeros(t):
        if not cfg.offload_opt_state:
            return sharding.set_spec(torch.zeros_like(t),
                                     sharding.spec_of(t))
        return sharding.set_spec(
            torch.zeros(t.shape, dtype=t.dtype, device="cpu",
                        pin_memory=t.device.type == "cuda"),
            sharding.spec_of(t))

    return TrainState(
        params=params,
        opt_state={"mu": [zeros(t) for t in train],
                   "nu": [zeros(t) for t in train],
                   "count": 0},
        step=0)


@dataclass(frozen=True)
class HostPlacement:
    """Where an offloaded moment lives: host memory, pinned when the params
    are on a card (the copy engines then move it without a staging copy).
    The port's counterpart of a ``pinned_host`` sharding."""
    device: torch.device
    pinned: bool


def host_opt_shardings(state: TrainState) -> Dict[str, List[HostPlacement]]:
    """Per-moment placements pinning the optimizer state to host memory:
    ``{"mu": [...], "nu": [...]}`` in the moments' order. Params on the CPU
    already live in host memory; their moments stay ordinary CPU tensors
    (pinning needs a CUDA runtime)."""
    on_card = state.params["text"]["embed"].device.type == "cuda"
    place = HostPlacement(torch.device("cpu"), on_card)
    return {name: [place] * len(state.opt_state[name])
            for name in ("mu", "nu")}


def offload_opt_state(state: TrainState) -> TrainState:
    """Move the Adam moments to pinned host memory (``host_opt_shardings``):
    they stop occupying the card, at the cost of a host <-> card transfer
    a step (``make_offloaded_step``). Call once after ``init_train_state`` or
    a checkpoint restore; a moment already placed stays as it is (a restore
    copies into the existing pinned tensors). The moment lists are updated
    IN PLACE, so every holder of the state lets go of the card's copies,
    one leaf at a time."""
    place = host_opt_shardings(state)
    for name in ("mu", "nu"):
        moments = state.opt_state[name]
        for i, (t, where) in enumerate(zip(moments, place[name])):
            if t.device.type == "cpu" and (not where.pinned or t.is_pinned()):
                continue
            host = torch.empty(t.shape, dtype=t.dtype, device=where.device,
                               pin_memory=where.pinned)
            host.copy_(t)
            moments[i] = sharding.set_spec(host, sharding.spec_of(t))
    return TrainState(params=state.params, opt_state=state.opt_state,
                      step=state.step)


# elements of a leaf the offloaded update moves and updates at a time, and
# the device staging slots (mu and nu each) they rotate through
_OFFLOAD_CHUNK = 1 << 25
_OFFLOAD_SLOTS = 3


class _MomentStream:
    """Runs the optimizer's per-leaf update over moments held in host
    memory, in chunks of at most ``_OFFLOAD_CHUNK`` elements (the update is
    elementwise, so a chunk computes exactly what the whole leaf would).

    On a card: a ring of ``_OFFLOAD_SLOTS`` device staging slots (mu and
    nu), sized by the largest chunk, two copy streams, and events ordering them
    against the compute stream. Chunk k's moments come in on the H2D stream
    while chunk k - 1 updates, and chunk k - 2's go back on the D2H stream;
    a slot is refilled only after its write-back has read it. No host wait
    inside the loop; one at the end (the last write-back), so the next
    step and a checkpoint save see finished host moments. On the CPU the
    same ring is filled and drained by plain copies."""

    def __init__(self, stats: Optional[Dict[str, float]] = None):
        self.stats = stats
        self.slots: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.streams = None

    def _units(self, train):
        return [(i, a, min(a + _OFFLOAD_CHUNK, t.numel()))
                for i, t in enumerate(train)
                for a in range(0, t.numel(), _OFFLOAD_CHUNK)]

    def _stage(self, units, train, device):
        need = max((b - a) * train[i].element_size() for i, a, b in units)
        if not self.slots or self.slots[0][0].numel() < need \
                or self.slots[0][0].device != device:
            self.slots = [tuple(torch.empty(need, dtype=torch.uint8,
                                            device=device) for _ in range(2))
                          for _ in range(_OFFLOAD_SLOTS)]
        if device.type == "cuda" and self.streams is None:
            self.streams = (torch.cuda.Stream(device),
                            torch.cuda.Stream(device))

    def run(self, train, grads, mu, nu, update) -> None:
        for t in (*mu, *nu):
            if t.device.type != "cpu":
                raise RuntimeError("make_offloaded_step: a moment is on "
                                   f"{t.device}, not in host memory; call "
                                   "offload_opt_state first")
        if not all(p.is_contiguous() for p in train):
            raise RuntimeError("make_offloaded_step: a trainable leaf is "
                               "not contiguous")
        device = train[0].device
        cuda = device.type == "cuda"
        if cuda and not all(t.is_pinned() for t in (*mu, *nu)):
            raise RuntimeError("make_offloaded_step: a moment on the host is "
                               "not pinned; call offload_opt_state")
        units = self._units(train)
        self._stage(units, train, device)
        R = _OFFLOAD_SLOTS
        timed: List[Tuple[str, Any, Any]] = []  # (direction, start, end)
        if cuda:
            compute = torch.cuda.current_stream(device)
            streams = dict(zip(("h2d", "d2h"), self.streams))
            ev = {k: [torch.cuda.Event() for _ in range(R)]
                  for k in ("in", "upd", "out")}

        def host(m, k):   # chunk k of a host moment
            i, a, b = units[k]
            return m[i].view(-1)[a:b]

        def staged(k):    # slot k % R viewed as chunk k's mu and nu
            i, a, b = units[k]
            n = (b - a) * train[i].element_size()
            return [buf[:n].view(train[i].dtype)
                    for buf in self.slots[k % R]]

        def copy(direction, k, pairs):
            """H2D into slot k % R once its last write-back has read it;
            D2H once chunk k's update has written it."""
            if not cuda:
                for dst, src in pairs:
                    dst.copy_(src)
                return
            s = k % R
            wait, done = ((ev["out"][s], ev["in"][s]) if direction == "h2d"
                          else (ev["upd"][s], ev["out"][s]))
            stream = streams[direction]
            with torch.cuda.stream(stream):
                stream.wait_event(wait)
                if self.stats is not None:
                    t0 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                for dst, src in pairs:
                    dst.copy_(src, non_blocking=True)
                if self.stats is not None:
                    t1 = torch.cuda.Event(enable_timing=True)
                    t1.record()
                    timed.append((direction, t0, t1))
                done.record()

        def fetch(k):
            smu, snu = staged(k)
            copy("h2d", k, ((smu, host(mu, k)), (snu, host(nu, k))))

        fetch(0)
        for k, (i, a, b) in enumerate(units):
            if k + 1 < len(units):
                fetch(k + 1)
            smu, snu = staged(k)
            if cuda:
                compute.wait_event(ev["in"][k % R])
            update(train[i].view(-1)[a:b], grads[i].reshape(-1)[a:b], smu,
                   snu)
            if cuda:
                ev["upd"][k % R].record(compute)
            copy("d2h", k, ((host(mu, k), smu), (host(nu, k), snu)))
        if cuda:
            ev["out"][(len(units) - 1) % R].synchronize()  # the one wait
        if self.stats is not None:
            st = self.stats
            moved = 4 * sum(m.numel() * m.element_size() for m in mu)
            st["offload_bytes"] = st.get("offload_bytes", 0.0) + moved
            for direction in ("h2d", "d2h") if timed else ():
                key = f"offload_{direction}_s"
                st[key] = st.get(key, 0.0) + sum(
                    t0.elapsed_time(t1) / 1e3
                    for d, t0, t1 in timed if d == direction)
            if timed:
                st["offload_span_s"] = st.get("offload_span_s", 0.0) + \
                    timed[0][1].elapsed_time(timed[-1][2]) / 1e3


def make_offloaded_step(step_fn, state0: TrainState,
                        stats: Optional[Dict[str, float]] = None):
    """Wrap a train step (``make_train_step``) so the optimizer state lives
    in host memory between steps: the update streams each leaf's moments
    through the card and back (``_MomentStream``), and the step returns
    with the host moments final. ``state0`` must already be offloaded
    (``offload_opt_state``). ``stats`` gains ``offload_h2d_s`` /
    ``offload_d2h_s`` (device seconds of the copies), ``offload_span_s``
    (first copy in to last copy out) and ``offload_bytes``."""
    if any(t.device.type != "cpu" for name in ("mu", "nu")
           for t in state0.opt_state[name]):
        raise ValueError("make_offloaded_step: the moments are on the card; "
                         "call offload_opt_state first")
    stream = _MomentStream(stats)

    def wrapped(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        opt = state.opt_state
        new_state, metrics = step_fn(
            TrainState(params=state.params,
                       opt_state={**opt, "stream": stream}, step=state.step),
            batch, generator)
        opt["count"] = new_state.opt_state["count"]
        return TrainState(params=new_state.params, opt_state=opt,
                          step=new_state.step), metrics

    return wrapped


def _split_accum(batch: Dict[str, torch.Tensor], accum: int):
    """[B, ...] -> accum microbatches of [B/accum, ...]."""
    def r(x):
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


_NORM_CHUNK = 1 << 25


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the summed squares over all leaves, accumulated in fp32, a
    chunk of at most 2^25 elements at a time: the fp32 copy of a whole
    expert stack's gradient (13.5 GiB at 18 MoE layers) is never made."""
    if not grads:
        return torch.zeros(())

    def squares(g):
        return sum(c.to(torch.float32).square().sum()
                   for c in g.reshape(-1).split(_NORM_CHUNK))

    return torch.sqrt(sum(squares(g) for g in grads))


@torch.no_grad()
def apply_optimizer(train: List[torch.Tensor], grads: List[torch.Tensor],
                    opt_state: Dict[str, Any], cfg: TrainConfig,
                    gnorm: torch.Tensor) -> None:
    """One update of the optax chain ``clip_by_global_norm ->
    scale_by_adam -> add_decayed_weights -> scale_by_learning_rate``, in
    place on ``train`` and the moments, each operation in the leaf's dtype
    and in optax's order of operations. An ``opt_state["stream"]``
    (``make_offloaded_step``) runs the same update over host moments."""
    count_inc = opt_state["count"] + 1
    lr = make_schedule(cfg)(opt_state["count"])
    clip = bool(cfg.grad_clip) and not bool(gnorm < cfg.grad_clip)
    bc1 = 1 - cfg.b1 ** count_inc
    bc2 = 1 - cfg.b2 ** count_inc

    def update(p, g, mu, nu):
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

    stream = opt_state.get("stream")  # make_offloaded_step's
    if stream is not None:
        stream.run(train, grads, opt_state["mu"], opt_state["nu"], update)
    else:
        for p, g, mu, nu in zip(train, grads, opt_state["mu"],
                                opt_state["nu"]):
            update(p, g, mu, nu)
    opt_state["count"] = count_inc


# the train step's phases: the ``stats`` key of each and its span
_PHASES = (("forward_s", "molly/forward"), ("backward_s", "molly/backward"),
           ("optimizer_s", "molly/optimizer"))


def make_loss_fn(model_cfg: FusionConfig, train_cfg: TrainConfig):
    """Returns (params, batch, generator) -> (loss, metrics): the step's
    loss (LM loss, and an MoE decoder's router term) and its metrics; under
    a mesh, this rank's share of the global batch's loss (the GPipe
    decoder under ``pp_micro``, the sequence laid out by ``_seq_layout``
    under context parallelism)."""
    lora_cfg = train_cfg.lora
    if train_cfg.pp_micro:
        assert lora_cfg is None, "LoRA + pipeline parallelism unsupported"

    def loss_fn(params, batch, generator):
        mesh = comm.current_mesh()
        if train_cfg.pp_micro:
            from ..parallel.pipeline import pp_loss_fn
            return pp_loss_fn(params, model_cfg, batch,
                              n_micro=train_cfg.pp_micro,
                              z_loss=train_cfg.z_loss)
        text_cfg, positions, pre_shifted = model_cfg.text, None, False
        embeds = fusion.build_inputs_embeds(params, model_cfg, batch)
        mask = batch.get("attention_mask")
        n_seq = (mesh.size(sharding.SEQ_AXIS)
                 if mesh is not None and text_cfg.context_parallel else 1)
        if n_seq > 1:
            embeds, mask, positions, batch = _seq_layout(
                embeds, mask, batch, mesh, text_cfg.context_parallel_zigzag)
            pre_shifted = True
            if text_cfg.context_parallel_zigzag:
                text_cfg = dataclasses.replace(
                    text_cfg, context_parallel_prepermuted=True)
        hidden, aux_out = qwen3.forward_hidden(
            params["text"], text_cfg, inputs_embeds=embeds,
            attention_mask=mask, positions=positions,
            lora=params.get("lora"),
            lora_scale=lora_cfg.scale if lora_cfg else 1.0,
            lora_dropout=lora_cfg.dropout if lora_cfg else 0.0,
            generator=generator if (lora_cfg and lora_cfg.dropout > 0)
            else None)
        loss, metrics = fusion.loss_from_hidden(
            params, model_cfg, hidden, batch, z_loss=train_cfg.z_loss,
            fused_lce=train_cfg.fused_lce, chunk_size=train_cfg.lce_chunk,
            pre_shifted=pre_shifted,
            # frozen head (LoRA or --train-llm false): the lm-head /
            # tied-embed weight gradient is dead — skip its matmul
            lce_need_dw=(train_cfg.lora is None and train_cfg.train_llm))
        if model_cfg.text.num_experts and aux_out is not None:
            # MoE router load-balance aux loss (ops.moe), with the HF
            # Qwen3-MoE config's coefficient (router_aux_loss_coef); under a
            # mesh lb is the global batch's and each batch rank adds its
            # share
            moe_aux = aux_out["moe_aux"]
            lb = moe_aux["load_balance"]
            n_b = mesh.size(*sharding.BATCH_AXES) if mesh is not None else 1
            loss = loss + model_cfg.text.router_aux_coef * lb / n_b
            metrics = {**metrics, "moe_load_balance": lb}
            if "ep_dropped_frac" in moe_aux:
                metrics["moe_ep_dropped_frac"] = moe_aux["ep_dropped_frac"]
        return loss, metrics

    return loss_fn


def make_grad_fn(model_cfg: FusionConfig, train_cfg: TrainConfig):
    """Returns (params, batch, generator) -> (grads, metrics): the loss's
    gradients wrt the trainable leaves (a list in tree order, see
    ``_trainable_leaves``) with the microbatch loop, and the metrics summed
    as the JAX step sums them (under a mesh: the global batch's metrics,
    and each rank's gradients of its blocks, summed over the batch axes).

    The loss is differentiated ONLY wrt the trainable leaves: frozen leaves
    do not require grad, so their backward passes never run — with frozen
    encoders the whole encoder backward disappears, and under LoRA the
    base-weight gradient products do."""
    loss_fn = make_loss_fn(model_cfg, train_cfg)

    def grads_of(params, train, batch, generator):
        with profiling.span("molly/forward", device=True), \
                torch.enable_grad():
            loss, metrics = loss_fn(params, batch, generator)
        # the gradients, a mesh's gradient sync included
        with profiling.span("molly/backward", device=True):
            with torch.enable_grad():
                grads = torch.autograd.grad(loss, train, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for g, t in zip(grads, train)]
            metrics = {k: v.detach() for k, v in metrics.items()}
            mesh = comm.current_mesh()
            if mesh is not None:
                grads = sharding.sync_grads(
                    grads, [sharding.spec_of(t) for t in train], mesh)
                group = mesh.group(*sharding.BATCH_AXES)
                # (moe_ep_dropped_frac is already the global batch's)
                metrics["loss"] = comm.all_reduce(metrics["loss"], group)
        return grads, metrics

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
        for mk in ("loss", "moe_load_balance", "moe_ep_dropped_frac"):
            if mk in metrics:
                metrics[mk] = metrics[mk] / accum
        return [g / accum for g in grads], metrics

    return grad_fn


def make_eval_loss(model_cfg: FusionConfig, train_cfg: TrainConfig):
    """(params, batch) -> the eval loss ``fusion.loss_fn`` gives (no z-loss,
    no router term), under a mesh summed over the ranks' shares: the
    global batch's mean, laid out as the train step lays it out (the
    pipeline, the sequence parts)."""
    eval_cfg = dataclasses.replace(train_cfg, z_loss=0.0)
    loss_fn = make_loss_fn(model_cfg, eval_cfg)

    @torch.no_grad()
    def eval_loss(params, batch):
        if comm.current_mesh() is None:
            return fusion.loss_fn(params, model_cfg, batch)[0]
        metrics = loss_fn(params, batch, None)[1]
        mesh = comm.current_mesh()
        return comm.all_reduce(metrics["loss"].detach(),
                               mesh.group(*sharding.BATCH_AXES))

    return eval_loss


def make_train_step(model_cfg: FusionConfig, train_cfg: TrainConfig,
                    stats: Optional[Dict[str, float]] = None):
    """Returns (state, batch, generator) -> (state, metrics). ``batch`` holds
    tensors on the params' device; ``generator`` (on that device) feeds the
    LoRA dropout and may be None when there is none. ``stats``, when given,
    accumulates seconds per phase over the steps (``forward_s``,
    ``backward_s``, ``optimizer_s``: the spans ``molly/forward``,
    ``molly/backward`` and ``molly/optimizer``, CUDA event time on a card,
    host time on the CPU), read after one synchronize at the end of each
    step."""
    grad_fn = make_grad_fn(model_cfg, train_cfg)
    schedule = make_schedule(train_cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        rec = {} if stats is not None else None
        with profiling.recording(rec):
            grads, metrics = grad_fn(state.params, batch, generator)
            # the norm, the guard's sync and the update
            with profiling.span("molly/optimizer", device=True):
                # grad norm over the params being optimized (also what the
                # clip inside the optimizer sees); under a mesh each
                # distinct block once
                if comm.current_mesh() is not None:
                    gnorm = sharding.global_norm(
                        grads, [sharding.spec_of(t) for t in
                                _trainable_leaves(state.params, train_cfg)])
                else:
                    gnorm = global_norm(grads)
                # NaN/Inf guard: skip the update, keep the old state
                ok = bool(torch.isfinite(metrics["loss"])
                          & torch.isfinite(gnorm).to(metrics["loss"].device))
                if ok:
                    apply_optimizer(
                        _trainable_leaves(state.params, train_cfg), grads,
                        state.opt_state, train_cfg, gnorm)
            if rec is not None and gnorm.is_cuda:
                torch.cuda.synchronize(gnorm.device)
        if rec:
            for key, name in _PHASES:
                sp = rec["spans"][name]
                stats[key] = stats.get(key, 0.0) + (
                    sp["host_s"] if sp["device_s"] is None
                    else sp["device_s"])
        metrics = {**metrics, "grad_norm": gnorm, "skipped": not ok,
                   "learning_rate": schedule(state.step)}
        return TrainState(params=state.params, opt_state=state.opt_state,
                          step=state.step + 1), metrics

    return train_step


def _seq_layout(embeds, mask, batch, mesh, zigzag: bool):
    """The context-parallel layout of one step (JAX ``trainer.py:230-295``):
    positions from the whole mask, labels shifted to their positions BEFORE
    any reordering, the zigzag order when asked, then this rank's
    contiguous part of the (reordered) sequence. The token-summed loss does
    not depend on the order once the labels ride along."""
    from ..parallel.ring_attention import zigzag_order
    B, S, _ = embeds.shape
    n, i = mesh.size(sharding.SEQ_AXIS), mesh.index(sharding.SEQ_AXIS)
    if mask is None:
        positions = torch.arange(S, device=embeds.device)[None].expand(B, S)
    else:
        positions = torch.clamp(
            torch.cumsum(mask.to(torch.int32), dim=1) - 1, min=0)
    lbl = batch["labels"]
    lbl = torch.cat([lbl[:, 1:], torch.full((B, 1), LABEL_IGNORE,
                                            dtype=lbl.dtype,
                                            device=lbl.device)], dim=1)
    if zigzag:
        order = zigzag_order(S, n).to(embeds.device)
        embeds, positions, lbl = (x.index_select(1, order)
                                  for x in (embeds, positions, lbl))
        if mask is not None:
            mask = mask.index_select(1, order)
    s = S // n

    def part(x):
        return x[:, i * s:(i + 1) * s] if x is not None else None

    return (part(embeds), part(mask), part(positions),
            {**batch, "labels": part(lbl)})


def attach_lora(params: Dict[str, Any], model_cfg: FusionConfig,
                lora_cfg: LoraConfig, generator: torch.Generator,
                dtype=torch.float32) -> Dict[str, Any]:
    """Add a fresh adapter tree to a fusion param tree (LoRA regime), on
    the device of the text embedding (``generator`` lives there)."""
    device = params["text"]["embed"].device
    return {**params,
            "lora": lora_lib.init_lora(model_cfg.text, lora_cfg, generator,
                                       dtype, device)}
