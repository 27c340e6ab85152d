"""Diffusion training step (eps-MSE) over a trainable subset of the UNet
(layoutllm_t2i_tpu/training/train_step.py; reference GLIGEN/
trainer_combined_layout.py:397-420 run_one_step, trainable selection
:248-260).

``TrainStep`` is the JAX package's partitioned train step: only the
trainable parameters (``TRAINABLE_MODES``, a predicate on the dotted
state_dict name) carry ``requires_grad`` and optimizer state; the frozen
rest of the UNet is read-only input and never gets a ``.grad``. Gradients
are taken with ``torch.autograd.grad`` over the trainable tensors alone.

The default, as the JAX package's, is f32 throughout (the kernels' f32
forms on the card). Mixed precision (``mixed_precision=True``) computes in
bf16 from f32 master weights: the frozen weights are cast to bf16 once at
setup (the cast is deterministic, so every step sees the values a per-step
cast would give), the trainable ones every step through a differentiable
cast, so their gradients arrive in f32, as the JAX cast transpose gives
them. In f32 the "cast" of a frozen weight is the master itself (``.to``
of the same type returns the tensor): no copy of the frozen UNet is made.
The MSE is taken in f32 against the f32 noise.

The optimizer mirrors optax, not torch's defaults: ``optax.adamw(schedule,
weight_decay)`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
decoupled decay) or ``optax.sgd(schedule)``, with the schedule evaluated at
the update count before it is incremented.

On a ``Mesh`` of more than one process (data parallel: the JAX trainer's
1-D ``data`` mesh, batch sharded and the state replicated) each rank holds
its rows of the global batch and the same masters. A rank makes the global
(micro)batch's draws from a generator seeded as every other rank's and
keeps its rows of them, so each row gets the draws it gets at world 1;
after the microbatch loop the gradients and the loss are averaged over the
ranks in one bucketed all-reduce, the all-reduce GSPMD inserts. Under
ZeRO-1 (``zero1``) each trainable leaf's moments and EMA hold only this
rank's block along ``zero1_dim`` (leaves without one stay whole): a rank
updates its block of each master from the all-reduced gradient, and the
blocks are all-gathered back into the whole masters. The update is
elementwise, so ZeRO-1 makes plain data parallel's update bit for bit.
World 1 runs no collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.utils.checkpoint

from ..diffusion.ddpm import q_sample
from ..models.unet import UNetConfig, unet_apply
from ..ops.nn import CL
from ..ops.schedules import DDPMSchedule
from ..parallel.collectives import all_gather_slices, all_reduce_mean_
from ..parallel.mesh import Mesh, zero1_dim
from ..utils.trees import ParamTree, unflatten_tree


def rela_fuse_only(name: str) -> bool:
    parts = name.split(".")
    return "transformer_blocks" in parts and "rela_fuse" in parts


def fuser_and_position_net(name: str) -> bool:
    parts = name.split(".")
    return "fuser" in parts or "position_net" in parts


TRAINABLE_MODES: Dict[str, Callable[[str], bool]] = {
    "rela_fuse": rela_fuse_only,            # LayoutLLM-T2I relation training
    "gligen": fuser_and_position_net,       # vanilla GLIGEN grounding training
    "all": lambda name: True,
}


@dataclasses.dataclass
class TrainStepConfig:
    unet_cfg: UNetConfig
    schedule: DDPMSchedule
    trainable_mode: str = "rela_fuse"
    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    warmup_steps: int = 10000
    total_steps: int = 500_000
    lr_schedule: str = "constant"  # constant | cosine, both with warmup
    grounding_drop_prob: float = 0.1  # CFG drop (openaimodel.py:421-422)
    ema_rate: Optional[float] = None  # EMA of the trainable params, or none
    # recompute the UNet forward in backward (torch.utils.checkpoint), the
    # JAX package's jax.checkpoint option
    remat: bool = False
    # bf16 compute with f32 master weights; False (the JAX package's
    # default): f32 throughout
    mixed_precision: bool = False
    # k microbatches, gradients averaged, one optimizer/EMA update
    accum_steps: int = 1
    optimizer: str = "adamw"  # adamw | sgd (sgd keeps no state)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32


# ---------------------------------------------------------------------------
# learning-rate schedules: optax's, as plain functions of the update count


def learning_rate(cfg: TrainStepConfig, count: int) -> float:
    """The schedule at the pre-increment update count ``count``:
    constant = join(linear_schedule(0, lr, warmup), constant(lr)) at warmup;
    cosine = warmup_cosine_decay_schedule(0, lr, warmup, total_steps)."""
    peak, warm = cfg.learning_rate, cfg.warmup_steps
    if count < warm:  # optax.linear_schedule(0, peak, warm)
        return peak * count / warm
    if cfg.lr_schedule != "cosine":
        return peak
    decay = cfg.total_steps - warm
    if decay <= 0:
        raise ValueError(f"cosine schedule needs total_steps > warmup_steps, "
                         f"got {cfg.total_steps} and {warm}")
    c = min(count - warm, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))


class Optimizer:
    """optax.adamw / optax.sgd over a list of f32 tensors, in place."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainStepConfig, params: List[torch.Tensor]):
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"optimizer {cfg.optimizer!r}: adamw or sgd")
        self.cfg = cfg
        self.count = 0
        adam = cfg.optimizer == "adamw"
        self.mu = [torch.zeros_like(p) for p in params] if adam else []
        self.nu = [torch.zeros_like(p) for p in params] if adam else []

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        lr = learning_rate(self.cfg, self.count)
        if self.cfg.optimizer == "sgd":
            torch._foreach_add_(params, grads, alpha=-lr)
        else:
            b1, b2 = self.B1, self.B2
            t = self.count + 1
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(self.nu, 1.0 - b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            step = torch._foreach_div(self.mu, 1.0 - b1 ** t)
            torch._foreach_div_(step, denom)
            if self.cfg.weight_decay:
                torch._foreach_add_(step, params, alpha=self.cfg.weight_decay)
            torch._foreach_add_(params, step, alpha=-lr)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for d, s in zip(dst, state[key]):
                d.copy_(s)


# ---------------------------------------------------------------------------
# loss


def draw(cfg: TrainStepConfig, generator: torch.Generator, z: torch.Tensor,
         mesh: Optional[Mesh] = None):
    """(t, noise, keep) from ``generator``: t = floor(U * T) with T -> T-1
    (trainer_combined_layout.py:379-381), Gaussian f32 noise shaped like z,
    and ONE grounding-drop draw for the whole batch (train_step.py:178).
    On a ``mesh`` of n ranks, ``z`` is this rank's block of a global batch
    of n blocks: t and the noise are drawn for the global batch and this
    rank keeps its block's rows (every rank's generator is seeded alike, so
    all agree on every draw and on the one keep)."""
    n_t = cfg.schedule.num_timesteps
    dev = z.device
    world = 1 if mesh is None else mesh.size
    rows = z.shape[0]
    u = torch.rand(rows * world, generator=generator, device=dev)
    t = (u * n_t).long()
    t = torch.where(t == n_t, n_t - 1, t)
    noise = torch.randn((rows * world,) + tuple(z.shape[1:]),
                        generator=generator, device=dev, dtype=torch.float32)
    keep = (torch.rand((), generator=generator, device=dev)
            >= cfg.grounding_drop_prob).float()
    if world > 1:
        blk = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
        t, noise = t[blk], noise[blk]
    return t, noise.contiguous(memory_format=CL), keep


def loss_from_draws(cfg: TrainStepConfig, params, batch: dict,
                    t: torch.Tensor, noise: torch.Tensor,
                    keep: torch.Tensor) -> torch.Tensor:
    """f32 MSE between the UNet's eps and ``noise`` at q_sample(z, t, noise).

    params: the UNet tree in the compute dtype; batch: z (B, 4, h, w) f32
    channels_last clean latents, context (B, 77, C), boxes (B, MO, 4),
    masks (B, MO), phrase_embeddings (B, MO, C), relations (B, R, C). The
    grounding inputs are multiplied by ``keep`` (the null input is zeros,
    text_layout_tokinzer_input.py:47-62)."""
    dt = cfg.compute_dtype
    x_noisy = q_sample(cfg.schedule, batch["z"], t, noise).to(dt)
    x_noisy = x_noisy.contiguous(memory_format=CL)
    args = (x_noisy, t, batch["context"].to(dt), batch["boxes"] * keep,
            batch["masks"] * keep, batch["phrase_embeddings"].to(dt) * keep,
            batch["relations"].to(dt))
    if cfg.remat:
        eps = torch.utils.checkpoint.checkpoint(
            unet_apply, params, cfg.unet_cfg, *args, use_reentrant=False)
    else:
        eps = unet_apply(params, cfg.unet_cfg, *args)
    return torch.mean((eps.float() - noise) ** 2)


# ---------------------------------------------------------------------------
# the partitioned train step


class TrainStep:
    """One optimizer update per call over the trainable subset of ``unet``
    (make_partitioned_train_step). ``unet`` holds the f32 master weights.

    mesh: the data-parallel group (None: one process); each call's batch
    is then this rank's rows of the global batch (``mesh.batch_rows``).
    zero1: the moments and the EMA hold this rank's ``zero1_dim`` block of
    each leaf (the JAX trainer's ``zero1_sharding`` of them)."""

    def __init__(self, cfg: TrainStepConfig, unet: ParamTree,
                 mesh: Optional[Mesh] = None, zero1: bool = False):
        self.cfg = cfg
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps {cfg.accum_steps} must be >= 1")
        self.unet = unet
        self.params = unet.set_trainable(TRAINABLE_MODES[cfg.trainable_mode])
        # None: a world of one, made without a group
        self.mesh = mesh or Mesh(0, 1, next(iter(self.params.values())).device)
        # the dimension each leaf's optimizer state is split along, or None
        self.zero1_dims = [zero1_dim(tuple(p.shape), self.mesh.size) if zero1 else None
                           for p in self.params.values()]
        # this rank's blocks of the masters, which the optimizer updates: a
        # view of the master where it is contiguous, else a copy that the
        # all-gather after each update writes back
        self._blocks = self._own(self.params.values(), dense=True)
        self.optimizer = Optimizer(cfg, self._blocks)
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {n: b.detach().clone() for n, b in zip(self.params, self._blocks)}
            if cfg.ema_rate is not None else None)
        self.step = 0
        dt = cfg.compute_dtype
        # in f32 each entry aliases its master (detach() shares storage and
        # .to() of the same type returns it)
        self._frozen = {n: p.detach().to(dt) for n, p in unet.named_parameters()
                        if n not in self.params}

    def _own(self, tensors, dense: bool = False) -> List[torch.Tensor]:
        """This rank's block of each trainable leaf (or of a tensor of its
        shape) along its ZeRO-1 dim; the whole tensor where there is none.
        ``dense``: each block contiguous (a copy where the view is not), so
        that the optimizer's foreach ops take the same fused kernels on the
        blocks as on whole leaves, which keeps ZeRO-1 bit-equal on the
        card."""
        out = []
        for t, d in zip(tensors, self.zero1_dims):
            if d is not None:
                per = t.shape[d] // self.mesh.size
                t = t.detach().narrow(d, self.mesh.rank * per, per)
                if dense:
                    t = t.contiguous()
            out.append(t)
        return out

    def _whole_on_host(self, blocks) -> List[torch.Tensor]:
        """Host copies of whole leaves from every rank's ``blocks``, which
        hold state of the trainable leaves' shapes (collective under
        ZeRO-1: every rank calls it)."""
        outs = [torch.empty(p.shape, dtype=b.dtype)
                for p, b in zip(self.params.values(), blocks)]
        all_gather_slices(self.mesh, [b.detach() for b in blocks], outs,
                          self.zero1_dims)
        return outs

    def compute_params(self):
        """The UNet tree in the compute dtype; the trainable leaves are cast
        here, inside autograd, so their gradients reach the f32 masters."""
        dt = self.cfg.compute_dtype
        flat = dict(self._frozen)
        flat.update({n: p.to(dt) for n, p in self.params.items()})
        return unflatten_tree(flat)

    def grads(self, batch: dict, t, noise, keep):
        """(loss, gradients of the trainable tensors) for given draws."""
        loss = loss_from_draws(self.cfg, self.compute_params(), batch, t,
                               noise, keep)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        return loss.detach(), grads

    def __call__(self, batch: dict, generator: torch.Generator) -> torch.Tensor:
        """Draw, backpropagate over ``accum_steps`` microbatches, average
        the gradients and the loss over the ranks, update. Returns the mean
        loss as a 0-d device tensor (no host sync)."""
        k = self.cfg.accum_steps
        b = batch["z"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} must divide into {k} microbatches")
        loss_sum, grad_sum = 0.0, None
        for i in range(k):
            mb = {key: v[i * b // k:(i + 1) * b // k] for key, v in batch.items()}
            loss, grads = self.grads(mb, *draw(self.cfg, generator, mb["z"],
                                               self.mesh))
            loss_sum = loss_sum + loss.detach()
            if grad_sum is None:
                grad_sum = list(grads)
            else:
                torch._foreach_add_(grad_sum, grads)
        if k > 1:
            torch._foreach_div_(grad_sum, float(k))
        loss = loss_sum / k
        all_reduce_mean_(self.mesh, grad_sum + [loss])
        self.update(grad_sum)
        return loss

    def update(self, grads: List[torch.Tensor]) -> None:
        """One optimizer and EMA update from the global batch's gradients
        (the same on every rank): this rank's blocks under ZeRO-1, then the
        blocks all-gathered into the whole masters."""
        params = self._blocks
        self.optimizer.update(params, self._own(grads, dense=True))
        if self.mesh.size > 1 and any(d is not None for d in self.zero1_dims):
            all_gather_slices(self.mesh, params, list(self.params.values()),
                              self.zero1_dims)
        if self.ema is not None:
            with torch.no_grad():
                ema = list(self.ema.values())
                torch._foreach_mul_(ema, self.cfg.ema_rate)
                torch._foreach_add_(ema, params, alpha=1.0 - self.cfg.ema_rate)
        self.step += 1

    # -- checkpoint state: the trainable params, optimizer, step, EMA -------

    def state_dict(self) -> dict:
        """A host copy (taken now: the next update changes the tensors in
        place) in the one-process format: the whole moments and EMA, every
        rank's blocks gathered under ZeRO-1 (collective: every rank calls
        it)."""
        host = lambda ts: [t.detach().to("cpu", copy=True) for t in ts]
        opt = self.optimizer.state_dict()
        return {
            "params": dict(zip(self.params, host(self.params.values()))),
            "opt": {"count": opt["count"],
                    "mu": self._whole_on_host(opt["mu"]) if opt["mu"] else [],
                    "nu": self._whole_on_host(opt["nu"]) if opt["nu"] else []},
            "step": self.step,
            "ema": (None if self.ema is None else dict(zip(
                self.ema, self._whole_on_host(list(self.ema.values()))))),
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """From ``state_dict``'s format, whatever world wrote it: this rank
        takes its blocks of the moments and the EMA."""
        for name, p in self.params.items():
            p.copy_(state["params"][name])
        self._blocks = self._own(self.params.values(), dense=True)
        opt = state["opt"]
        self.optimizer.load_state_dict(
            {"count": opt["count"], "mu": self._own(opt["mu"]),
             "nu": self._own(opt["nu"])})
        self.step = int(state["step"])
        if self.ema is not None:
            # an EMA newly enabled against a pre-EMA checkpoint starts from
            # the restored params
            src = state["ema"] if state["ema"] is not None else state["params"]
            for e, s in zip(self.ema.values(),
                            self._own([src[n] for n in self.ema])):
                e.copy_(s)
