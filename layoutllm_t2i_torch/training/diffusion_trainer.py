"""Relation-aware diffusion trainer on one device
(layoutllm_t2i_tpu/training/diffusion_trainer.py; the rebuild of
trainer_combined_layout.py).

  * the model bundle is built from a seed at SD-1.4 geometry, or taken from
    the caller (a port ``GligenModels``; JAX trees cross over through
    checkpoint/from_jax.py); VAE and text encoder frozen, the UNet trained
    under a mode ('rela_fuse' for LayoutLLM-T2I, 'gligen', 'all');
  * ``prepare_batch``: VAE encode with a posterior sample, CLIP context,
    pooled phrase and relation embeddings (power-of-two bucketed), all in
    f32 whatever the compute dtype, as the JAX trainer encodes;
  * ``TrainStep``: eps-MSE, backward through the kernels, optax-style
    AdamW/SGD on the trainable subset, optional EMA;
  * checkpoints with embedded config and tagNN auto-resume
    (trainer_combined_layout.py:147-176, 523-535), written on a background
    thread; JSONL metrics;
  * with ``disable_inference_in_training=False``, a PLMS sample grid of the
    current weights on the saved iteration's batch at every save
    (``sample_previews``, trainer_combined_layout.py:457-521), through one
    ``InferencePipeline`` a run that reads the trainer's live UNet tensors.

One ``torch.Generator`` seeded from ``TrainerConfig.seed`` draws the VAE
posterior sample, the timestep, the noise, the grounding drop and the
previews' noise; nothing reads the global RNG. A run can start from a
reference GLIGEN ``.pth`` (``TrainerConfig.ckpt_path``). Not ported yet
(raises NotImplementedError and names its ROADMAP.md item by title): more
than one device and ZeRO-1 ("parallel/ for training").
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint.async_io import AsyncWriter
from ..checkpoint.export import export_gligen_checkpoint
from ..checkpoint.io import (create_run_dir_with_auto_resume, load_checkpoint,
                             save_checkpoint)
from ..device import DeviceLike
from ..models.clip_text import clip_text_apply
from ..models.vae import encode as vae_encode
from ..ops.nn import nhwc_to_nchw
from ..pipeline.inference import (GligenModels, InferencePipeline,
                                  encode_texts_bucketed)
from ..pipeline.loaders import load_models_from_gligen_ckpt, random_models
from ..pipeline.scene_graph import relation_texts_for_training
from ..utils.images import save_image_grid
from ..utils.logging import Logger, MetricsWriter
from ..utils.trees import ParamTree, unflatten_tree
from .train_step import TrainStep, TrainStepConfig


@dataclasses.dataclass
class TrainerConfig:
    output_root: str = "OUTPUT"
    name: str = "relation_training"
    batch_size: int = 8               # global batch
    total_iters: int = 500_000
    save_every_iters: int = 5000
    log_every: int = 10
    base_learning_rate: float = 5e-5
    weight_decay: float = 0.0
    warmup_steps: int = 10_000
    scheduler_type: str = "constant"
    trainable_mode: str = "rela_fuse"
    optimizer: str = "adamw"  # sgd = zero optimizer state
    max_boxes: int = 30
    max_relations: int = 10
    seed: int = 123
    ckpt_path: Optional[str] = None   # GLIGEN .pth to start from
    # periodic PLMS sample grid on a training batch at every save
    # (trainer_combined_layout.py:457-521); off by default like the
    # reference flag of the same name
    disable_inference_in_training: bool = True
    preview_steps: int = 50
    preview_guidance: float = 5.0
    # also write the reference 4-module dict .pth at every save
    export_reference_ckpt: bool = False
    # bf16 compute of the UNet with f32 master weights; False (the JAX
    # package's default): f32 throughout
    mixed_precision: bool = False
    enable_ema: bool = False
    ema_rate: float = 0.9999
    # gradient accumulation: batch_size is the EFFECTIVE batch
    accum_steps: int = 1
    zero1_opt_state: bool = False     # not ported
    # overlap checkpoint disk writes with training (checkpoint/async_io.py)
    async_ckpt: bool = True
    num_devices: Optional[int] = None  # None or 1: one device


def check_supported(config: TrainerConfig) -> None:
    """Raise on the options the port does not run yet."""
    if config.num_devices not in (None, 1) or config.zero1_opt_state:
        raise NotImplementedError(
            "data-parallel training over more than one device and ZeRO-1 "
            "are not ported (ROADMAP.md Queue 1, \"parallel/ for "
            "training\")")


def _prepare_models(models: GligenModels) -> GligenModels:
    """f32 master weights for the UNet, and the frozen VAE and text encoder
    in f32 whatever the compute dtype: the JAX trainer builds all three in
    f32 (``_build_models``) and only its train step casts the UNet's
    inputs, so the latents, the context, the phrase and relation embeddings
    and the exported VAE and CLIP weights are f32. The UNet's compute dtype
    is the train step's (``TrainStepConfig.compute_dtype``)."""
    models.unet_params.float()
    models.vae_params.float()
    models.clip_params.float()
    models.compute_dtype = torch.float32
    return models


class DiffusionTrainer:
    def __init__(self, config: TrainerConfig, dataset,
                 models: Optional[GligenModels] = None,
                 device: DeviceLike = None):
        """dataset: iterator of host batches with keys image (B, H, W, 3) in
        [-1, 1], caption (list[str]), boxes (B, MO, 4) xyxy, masks (B, MO),
        labels (list[list[str]]).

        models: a GligenModels bundle (its device is used), or None to load
        ``config.ckpt_path`` (a reference GLIGEN .pth) or, without one, to
        build random SD-1.4 weights from seed 0, on ``device`` (None: the
        card)."""
        check_supported(config)
        if config.batch_size % config.accum_steps != 0:
            raise ValueError(
                f"batch_size {config.batch_size} must divide into "
                f"accum_steps {config.accum_steps} microbatches")
        self.config = config
        self.dataset = dataset
        if models is None and config.ckpt_path:
            models = load_models_from_gligen_ckpt(
                config.ckpt_path, device=device, dtype=torch.float32)
        elif models is None:
            models = random_models(small=False, device=device,
                                   dtype=torch.float32, seed=0)
        self.device = models.device
        self.step_cfg = TrainStepConfig(
            unet_cfg=models.unet_cfg,
            schedule=models.schedule,
            trainable_mode=config.trainable_mode,
            optimizer=config.optimizer,
            learning_rate=config.base_learning_rate,
            weight_decay=config.weight_decay,
            warmup_steps=config.warmup_steps,
            total_steps=config.total_iters,
            lr_schedule=config.scheduler_type,
            mixed_precision=config.mixed_precision,
            ema_rate=config.ema_rate if config.enable_ema else None,
            accum_steps=config.accum_steps,
        )
        self.models = _prepare_models(models)
        self.train_step = TrainStep(self.step_cfg, models.unet_params)

        self.run_dir, resume_ckpt = create_run_dir_with_auto_resume(
            config.output_root, config.name)
        self.logger = Logger(os.path.join(self.run_dir, "log.txt"))
        self.metrics = MetricsWriter(os.path.join(self.run_dir, "metrics.jsonl"))
        self.ckpt_writer = AsyncWriter()
        self.starting_iter = 0
        if resume_ckpt is not None:
            loaded, _ = load_checkpoint(resume_ckpt)
            self.train_step.load_state_dict(loaded["state"])
            self.starting_iter = self.train_step.step
            self.logger.write(f"auto-resumed from {resume_ckpt} at iter "
                              f"{self.starting_iter}")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self._preview_pipe = None

    # -- batch encoding ------------------------------------------------------

    def encode_texts_pooled(self, texts) -> np.ndarray:
        """Pooled CLIP embeddings (n, hidden) f32 on the host."""
        if not texts:
            return np.zeros((0, self.models.clip_cfg.hidden_size), np.float32)
        pooled = encode_texts_bucketed(self.models, list(texts))[1]
        return pooled.float().cpu().numpy()

    def _grounding_tensors(self, captions, labels_list):
        """Per-box phrase embeddings and relation embeddings (the grounding
        prepare of trainer_combined_layout.py:334-369,410), all texts of the
        batch in one encoder call."""
        cfg = self.config
        hidden = self.models.clip_cfg.hidden_size
        b = len(captions)
        pos = np.zeros((b, cfg.max_boxes, hidden), np.float32)
        rel = np.zeros((b, cfg.max_relations, hidden), np.float32)
        flat, where = [], []
        for i, labels in enumerate(labels_list):
            for j, lab in enumerate(labels[: cfg.max_boxes]):
                flat.append(lab)
                where.append((pos, i, j))
        for i, cap in enumerate(captions):
            for j, text in enumerate(relation_texts_for_training(
                    cap, cfg.max_relations)):
                flat.append(text)
                where.append((rel, i, j))
        for (dst, i, j), e in zip(where, self.encode_texts_pooled(flat)):
            dst[i, j] = e
        return pos, rel

    @torch.no_grad()
    def prepare_batch(self, batch) -> dict:
        """Host batch -> device model inputs (get_input + grounding prepare,
        trainer_combined_layout.py:371-410)."""
        m = self.models
        dev = self.device
        ids = torch.from_numpy(m.tokenizer(batch["caption"]).astype(np.int64))
        images = torch.from_numpy(np.asarray(batch["image"], np.float32))
        images = nhwc_to_nchw(images.to(dev, torch.float32))
        z = vae_encode(m.vae_params, m.vae_cfg, images,
                       generator=self.generator, sample=True)
        context, _ = clip_text_apply(m.clip_params, m.clip_cfg, ids.to(dev))
        pos, rel = self._grounding_tensors(batch["caption"], batch["labels"])
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return {"z": z, "context": context, "boxes": f32(batch["boxes"]),
                "masks": f32(batch["masks"]), "phrase_embeddings": f32(pos),
                "relations": f32(rel)}

    # -- training loop -------------------------------------------------------

    def train(self):
        cfg = self.config
        it = iter(self.dataset)
        t_last = time.time()
        for iter_idx in range(self.starting_iter, cfg.total_iters):
            host_batch = next(it)
            batch = self.prepare_batch(host_batch)
            loss = self.train_step(batch, self.generator)
            if iter_idx % cfg.log_every == 0:
                loss_v = float(loss)  # the one host sync of a logged step
                dt = time.time() - t_last
                t_last = time.time()
                self.metrics.log(iter_idx, loss=loss_v,
                                 sec_per_iter=dt / max(cfg.log_every, 1))
                self.logger.write(f"iter {iter_idx}: loss={loss_v:.5f}")
            if (iter_idx == cfg.total_iters - 1
                    or (iter_idx > 0 and iter_idx % cfg.save_every_iters == 0)):
                if not cfg.disable_inference_in_training:
                    self.sample_previews(host_batch, iter_idx + 1)
                self.save_ckpt(iter_idx + 1)
        # join the in-flight checkpoint write (and surface its error)
        self.ckpt_writer.wait()
        self.logger.write("Training finished.")

    def close(self) -> None:
        self.ckpt_writer.wait()
        self.logger.close()
        self.metrics.close()

    # -- periodic sample previews (trainer_combined_layout.py:457-521) --------

    def _preview_pipeline(self) -> InferencePipeline:
        """ONE InferencePipeline a run, built at the first preview: PLMS at
        ``preview_steps``, guidance ``preview_guidance``, no alpha schedule,
        computing in the train step's dtype (bf16 under mixed precision,
        else f32). Its UNet is set at each preview to the train step's
        compute tree (``sample_previews``). The text encoder is the
        trainer's own f32 module, as the JAX preview encodes in f32; the
        frozen VAE decodes in the compute dtype, as the JAX preview decodes
        its latents cast to it: the trainer's f32 module in f32, under mixed
        precision a bf16 copy made here, once a run (the kernels take
        weights in their activations' type)."""
        if self._preview_pipe is None:
            m = self.models
            dtype = self.step_cfg.compute_dtype
            vae = m.vae_params
            if dtype != torch.float32:
                vae = ParamTree(unflatten_tree({
                    k: v.to(dtype) for k, v in vae.state_dict().items()}))
            models = GligenModels(
                unet_cfg=m.unet_cfg, unet_params=None, vae_cfg=m.vae_cfg,
                vae_params=vae, clip_cfg=m.clip_cfg,
                clip_params=m.clip_params, schedule=m.schedule,
                tokenizer=m.tokenizer, max_relas=self.config.max_relations,
                compute_dtype=dtype, device=self.device)
            self._preview_pipe = InferencePipeline(
                models, steps=self.config.preview_steps, sampler="plms",
                guidance_scale=self.config.preview_guidance, alpha_type=None)
        return self._preview_pipe

    @torch.no_grad()
    def sample_previews(self, host_batch, iter_name: int):
        """PLMS sample grid from the current weights on a training batch
        (reference: S=50, guidance 5, no alpha schedule), written as
        ``samples_<iter>.png`` beside ``real_<iter>.png`` in the run
        directory. The pipeline reads the live UNet: the train step's tree
        in its compute dtype, which aliases the f32 masters in f32 and is
        the bf16 copy the step already holds under mixed precision (only
        the small trainable tensors are cast here); no weight changes. The
        noise is one draw from the trainer's generator, (B, h, w, c) f32,
        after the step's draws, as the JAX trainer splits its key for it."""
        cfg = self.models.unet_cfg
        captions = list(host_batch["caption"])
        b = len(captions)
        pipe = self._preview_pipeline()
        pipe.models.unet_params = self.train_step.compute_params()
        pos, rel = self._grounding_tensors(captions, host_batch["labels"])
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device)
        cond = {"context": pipe.encode_text(captions),
                "uc_context": pipe.encode_text([""] * b),
                "boxes": f32(host_batch["boxes"]),
                "masks": f32(host_batch["masks"]),
                "phrase_embeddings": f32(pos), "relations": f32(rel)}
        noise = torch.randn((b, cfg.image_size, cfg.image_size,
                             cfg.in_channels), generator=self.generator,
                            device=self.device, dtype=torch.float32)
        imgs = pipe.sample_latents(cond, noise).cpu().numpy()
        pipe.models.unet_params = None
        out_path = os.path.join(self.run_dir, f"samples_{iter_name:08d}.png")
        save_image_grid(imgs, out_path, captions)
        real = np.asarray(host_batch["image"]) * 0.5 + 0.5
        save_image_grid(real, os.path.join(self.run_dir,
                                           f"real_{iter_name:08d}.png"))
        self.logger.write(f"saved sample previews to {out_path}")

    # -- checkpoints ---------------------------------------------------------

    def save_ckpt(self, iter_name: int):
        # synchronous part: the host snapshot of everything the write needs
        payload = {"state": self.train_step.state_dict(), "iters": iter_name}
        cfg_dict = dataclasses.asdict(self.config)
        cfg_dict["unet_cfg"] = dataclasses.asdict(self.models.unet_cfg)
        cfg_dict["vae_cfg"] = dataclasses.asdict(self.models.vae_cfg)
        cfg_dict["clip_cfg"] = dataclasses.asdict(self.models.clip_cfg)
        path = os.path.join(self.run_dir, f"checkpoint_{iter_name:08d}")
        export_args = None
        if self.config.export_reference_ckpt:
            host = lambda module: {
                k: v.detach().to("cpu", torch.float32, copy=True)
                for k, v in module.state_dict().items()}
            unet_sd = host(self.models.unet_params)
            ema = payload["state"]["ema"]
            export_args = (unet_sd, host(self.models.vae_params),
                           host(self.models.clip_params),
                           None if ema is None else {**unet_sd, **ema})

        def _write():
            save_checkpoint(path, payload, cfg_dict)
            save_checkpoint(os.path.join(self.run_dir, "checkpoint_latest"),
                            payload, cfg_dict)
            if export_args is not None:
                unet_sd, vae_sd, clip_sd, ema_sd = export_args
                pth = os.path.join(self.run_dir, f"checkpoint_{iter_name:08d}.pth")
                export_gligen_checkpoint(pth, unet_sd, vae_sd, clip_sd,
                                         self.models.schedule, cfg_dict,
                                         iters=iter_name, ema_unet_sd=ema_sd)
                self.logger.write(f"exported reference-format ckpt to {pth}")
            self.logger.write(f"saved checkpoint to {path}")

        if self.config.async_ckpt:
            self.ckpt_writer.submit(_write)
        else:
            _write()
