"""REINFORCE training of the layout policy (layoutllm_t2i_tpu/training/
rl_trainer.py; the reference's train_rl.py).

Per batch (train_rl.py:23-98, 116-257):
  1. score candidates: softmax(policy(train) @ policy(cand)^T / T) in f32;
  2. sample shot ids per example from the score rows (host RNG);
  3. build prompts, query the LLM (or the offline cached-layout LLM), regex-
     parse layouts; examples with empty predictions are dropped;
  4. generate images with the frozen diffusion pipeline (one batched
     PLMS-50 run — the dominant cost);
  5. composite reward; loss = sum(-log pi(shots) * reward); Adam step on the
     policy linear only.

The host RNG is ``np.random.default_rng(seed)``, drawn in the JAX trainer's
order (one ``choice`` per example, one ``integers`` per rollout batch), so
both packages pick the same shots and rollout seeds. torch's Adam applies
optax's ``adam`` update (both keep uncorrected moments and a step count);
``step()`` runs only on a batch that kept a row, as the JAX trainer
returns early on an empty one, so the step counts stay equal. The learning
rate is StepLR's, ``lr * gamma ** (epoch // step_size)``, set per batch.

Resume/save mirror the reference: per-epoch ckpt_E/state_E, best-reward and
best-loss snapshots, history.json, NaN abort. The ``.pt`` pair is the
reference format; ``ckpt_E.pkl`` is the JAX package's policy tree (a dict
of NumPy arrays, linear weight (in, out)). Resume reads the newest ``.pt``
pair: a JAX ``state_E.pkl`` is an optax state the port cannot read, and the
JAX trainer writes the ``.pt`` pair beside it. Each metrics.jsonl line adds
the batch's seconds (``batch_s``) and those of its rollouts and reward
(``rollout_s``, ``reward_s``) to the JAX trainer's fields.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.initializers import Init
from ..models.policy import init_policy_params, policy_scores
from ..pipeline.planner import build_prompt, center2lefttop, extract_prediction
from ..utils.buckets import pow2_bucket
from ..utils.logging import Logger, MetricsWriter


@dataclasses.dataclass
class RLConfig:
    epochs: int = 80
    batch_size: int = 8
    shot_number: int = 2
    lr: float = 1e-3
    lr_step_size: int = 20
    lr_gamma: float = 0.5
    policy_temperature: float = 1.0
    embedding_size: int = 128
    in_dim: int = 768
    seed: int = 53
    ckpt_path: str = "./checkpoints/rl"
    resume: str = ""


def _epochs(ckpt_dir: str, ext: str) -> List[int]:
    return [int(fn[len("state_"):-len(ext)]) for fn in os.listdir(ckpt_dir)
            if fn.startswith("state_") and fn.endswith(ext)]


class RLTrainer:
    def __init__(self, config: RLConfig, reward_model, generate_fn,
                 llm, train_examples: List[dict], cand_examples: List[dict],
                 feats_caps_train: np.ndarray, feats_caps_cand: np.ndarray,
                 batches, policy_params=None, logger: Optional[Logger] = None,
                 device: DeviceLike = None):
        """generate_fn(captions, layouts_ltrb_with_labels, seed) -> (B,H,W,3)
        [0,1] images — seed differs per rollout batch (the reference draws
        fresh noise per sample, interface.py:478-551; a fixed seed biases the
        REINFORCE rewards); llm(prompt) -> text; batches: iterable of
        (examples_chunk, gt_images, indices). ``policy_params``: a policy
        tree in the torch layout (``{'linear': {'weight' (out, in),
        'bias'}}``), copied; default a random one from the config's seed."""
        self.c = config
        self.device = resolve_device(device)
        self.reward_model = reward_model
        self.generate_fn = generate_fn
        self.llm = llm
        self.train_examples = train_examples
        self.cand_examples = cand_examples
        self.feats_train = self._f32(feats_caps_train)
        self.feats_cand = self._f32(feats_caps_cand)
        self.batches = batches
        self._own_logger = logger is None
        self.logger = logger or Logger(os.path.join(config.ckpt_path, "log.txt"))
        self.metrics = MetricsWriter(os.path.join(config.ckpt_path, "metrics.jsonl"))
        self.rng = np.random.default_rng(config.seed)

        if policy_params is None:
            gen = torch.Generator().manual_seed(config.seed)
            policy_params = init_policy_params(
                Init(gen, torch.device("cpu")), config.in_dim,
                config.embedding_size)
        self.params = {"linear": {
            k: torch.nn.Parameter(self._f32(policy_params["linear"][k]))
            for k in ("weight", "bias")}}
        # StepLR(step_size, gamma) stepped per epoch (train_rl.py:120,250)
        self._epoch = 0
        self.opt = torch.optim.Adam(self._param_list(), lr=config.lr,
                                    betas=(0.9, 0.999), eps=1e-8)

        self.start_epoch = 0
        if config.resume:
            self.start_epoch = self._resume(config.resume) + 1

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a).detach().to(self.device, torch.float32).clone()

    def _param_list(self) -> List[torch.nn.Parameter]:
        """nn.Linear.parameters() order: weight, bias (the ``state_E.pt``
        param ids 0 and 1)."""
        return [self.params["linear"]["weight"], self.params["linear"]["bias"]]

    def _scores(self, emb_batch: torch.Tensor) -> torch.Tensor:
        s = policy_scores(self.params, emb_batch, self.feats_cand)
        return torch.softmax(s / self.c.policy_temperature, dim=1)

    def _current_lr(self) -> float:
        return self.c.lr * (self.c.lr_gamma ** (self._epoch // self.c.lr_step_size))

    # -- ckpt ---------------------------------------------------------------

    def adam_state(self) -> Dict[str, Any]:
        """{'step', 'mu', 'nu'} of the Adam state, the moments in the policy
        tree's layout (``checkpoint/export.py export_policy_state``)."""
        w, b = self._param_list()
        st_w, st_b = self.opt.state.get(w, {}), self.opt.state.get(b, {})
        zero = lambda p: torch.zeros_like(p, device="cpu")
        return {
            "step": int(float(st_w.get("step", 0))),
            "mu": {"linear": {"weight": st_w.get("exp_avg", zero(w)),
                              "bias": st_b.get("exp_avg", zero(b))}},
            "nu": {"linear": {"weight": st_w.get("exp_avg_sq", zero(w)),
                              "bias": st_b.get("exp_avg_sq", zero(b))}},
        }

    def _save(self, epoch: int, tag: Optional[str] = None):
        """Checkpoints in both formats: the reference torch layout —
        ``ckpt_E.pt`` (bare linear state_dict) + ``state_E.pt``
        ({'optimizer','lr_scheduler'}), train_rl.py:218-222 — and the JAX
        package's policy tree as ``.pkl``. Both are exact f32 copies."""
        from ..checkpoint.export import (export_policy_checkpoint,
                                         export_policy_state)

        os.makedirs(self.c.ckpt_path, exist_ok=True)
        name = tag or f"ckpt_{epoch}"
        lin = self.params["linear"]
        jax_tree = {"linear": {
            "weight": lin["weight"].detach().cpu().numpy().T.copy(),
            "bias": lin["bias"].detach().cpu().numpy().copy()}}
        with open(os.path.join(self.c.ckpt_path, f"{name}.pkl"), "wb") as f:
            pickle.dump(jax_tree, f)
        export_policy_checkpoint(
            os.path.join(self.c.ckpt_path, f"{name}.pt"), self.params)
        if tag is None:
            export_policy_state(
                os.path.join(self.c.ckpt_path, f"state_{epoch}.pt"),
                self.adam_state(), epoch=epoch, lr=self.c.lr,
                lr_step_size=self.c.lr_step_size, lr_gamma=self.c.lr_gamma)

    def _resume(self, ckpt_dir: str) -> int:
        """Resume from the newest epoch's reference ``.pt`` pair
        (train_rl.py:100-113)."""
        from ..checkpoint.convert import load_policy, load_policy_state

        pt, pkl = _epochs(ckpt_dir, ".pt"), _epochs(ckpt_dir, ".pkl")
        if not pt or max(pkl, default=-1) > max(pt):
            raise FileNotFoundError(
                f"resume: {ckpt_dir} holds no state_E.pt for its newest epoch "
                f"(.pt epochs {sorted(pt)}, .pkl epochs {sorted(pkl)}); a "
                "state_E.pkl is an optax state, which this package does not "
                "read: resume from the state_E.pt the JAX trainer writes "
                "beside it")
        max_epoch = max(pt)
        params = load_policy(os.path.join(ckpt_dir, f"ckpt_{max_epoch}.pt"))
        st = load_policy_state(os.path.join(ckpt_dir, f"state_{max_epoch}.pt"))
        with torch.no_grad():
            for name, p in self.params["linear"].items():
                p.copy_(params["linear"][name])
        for p, name in zip(self._param_list(), ("weight", "bias")):
            self.opt.state[p] = {
                "step": torch.tensor(float(st["step"])),
                "exp_avg": self._f32(st["mu"]["linear"][name]),
                "exp_avg_sq": self._f32(st["nu"]["linear"][name])}
        self.logger.write(f"resumed from {ckpt_dir} at epoch {max_epoch}")
        return max_epoch

    # -- one batch ----------------------------------------------------------

    def run_batch(self, chunk, gt_images, indices):
        c = self.c
        self.timing = {"rollout_s": 0.0, "reward_s": 0.0}
        emb_batch = self.feats_train[torch.as_tensor(indices, device=self.device)]
        with torch.no_grad():
            scores = self._scores(emb_batch).cpu().numpy()

        captions, layouts_pred, layouts_gt = [], [], []
        chosen = np.zeros((len(chunk), c.shot_number), dtype=np.int64)
        valid = np.zeros((len(chunk),), dtype=np.float32)
        keep_rows = []
        for i, ex in enumerate(chunk):
            p = np.nan_to_num(scores[i].astype(np.float64), nan=1e-6)
            p = p / p.sum()
            cids = self.rng.choice(len(p), size=c.shot_number, replace=False, p=p)[::-1]
            chosen[i] = cids
            shots = [self.cand_examples[cid] for cid in cids]
            prompt = build_prompt(shots, ex["captions"])
            output = self.llm(prompt)
            categories, bboxes = extract_prediction(output)
            if len(categories) == 0:
                continue
            valid[i] = 1.0
            keep_rows.append(i)
            captions.append(ex["captions"])
            layouts_pred.append((bboxes, categories))
            layouts_gt.append((center2lefttop(ex["bbox"]), ex["label"]))

        if not keep_rows:
            return 0.0, 0.0

        # pad the rollout batch to the next power-of-two bucket (capped at
        # the chunk size) by repeating the last kept row, as the JAX trainer
        # does; the padded rewards are masked out below
        n_keep = len(keep_rows)
        bucket = pow2_bucket(n_keep, cap=len(chunk))
        pad = bucket - n_keep
        captions_p = captions + [captions[-1]] * pad
        layouts_pred_p = layouts_pred + [layouts_pred[-1]] * pad
        layouts_gt_p = layouts_gt + [layouts_gt[-1]] * pad
        gt_rows = keep_rows + [keep_rows[-1]] * pad
        seed = int(self.rng.integers(2 ** 31 - 1))  # fresh noise per rollout

        # both return host arrays, so the host clock spans their device work
        t0 = time.perf_counter()
        imgs_pred = self.generate_fn(captions_p, layouts_pred_p, seed=seed)
        t1 = time.perf_counter()
        rewards_padded = self.reward_model(
            captions_p, imgs_pred, gt_images[gt_rows], layouts_pred_p,
            layouts_gt_p,
        )
        self.timing = {"rollout_s": t1 - t0,
                       "reward_s": time.perf_counter() - t1}
        rewards = np.zeros((len(chunk),), dtype=np.float32)
        rewards[keep_rows] = np.asarray(rewards_padded, dtype=np.float32)[:n_keep]

        for group in self.opt.param_groups:
            group["lr"] = self._current_lr()
        self.opt.zero_grad(set_to_none=True)
        scores_t = self._scores(emb_batch)
        logp = torch.log(torch.gather(
            scores_t, 1, torch.as_tensor(chosen, device=self.device))).sum(dim=1)
        loss = torch.sum(-logp * torch.as_tensor(rewards, device=self.device)
                         * torch.as_tensor(valid, device=self.device))
        loss.backward()
        self.opt.step()
        return float(rewards.sum()), float(loss.detach())

    # -- training loop ------------------------------------------------------

    def train(self):
        c = self.c
        history = {"reward_history": [], "loss_history": [],
                   "total_reward_history": [], "total_loss_history": []}
        stop = False
        step = 0
        for epoch in range(self.start_epoch, self.start_epoch + c.epochs):
            self._epoch = epoch
            self.logger.write(f"Epoch: {epoch}")
            total_reward = total_loss = 0.0
            for chunk, gt_images, indices in self.batches:
                t0 = time.perf_counter()
                reward, loss = self.run_batch(chunk, gt_images, indices)
                total_reward += reward
                total_loss += loss
                history["reward_history"].append(reward)
                history["loss_history"].append(loss)
                self.metrics.log(step, reward=reward, loss=loss, lr=self._current_lr(),
                                 batch_s=time.perf_counter() - t0, **self.timing)
                step += 1
                if np.isnan(loss):
                    stop = True
                    break
            history["total_reward_history"].append(total_reward)
            history["total_loss_history"].append(total_loss)

            best_r = max(history["total_reward_history"])
            best_l = min(history["total_loss_history"])
            self.logger.write(
                f"### Epoch {epoch}: reward={total_reward:.3f} loss={total_loss:.3f} "
                f"best_reward={best_r:.3f} best_loss={best_l:.3f}"
            )
            self._save(epoch)
            if total_reward == best_r:
                self._save(epoch, tag="ckpt_best_reward")
            if total_loss == best_l:
                self._save(epoch, tag="ckpt_best_loss")
            with open(os.path.join(c.ckpt_path, "history.json"), "w") as f:
                json.dump(history, f, indent=2)
            if stop:
                break
        self._save(self.start_epoch + c.epochs - 1, tag="ckpt_final")
        return history

    def close(self) -> None:
        """Close the metrics file, and the log file if the trainer opened it."""
        self.metrics.close()
        if self._own_logger:
            self.logger.close()
