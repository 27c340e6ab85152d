"""Relation-aware diffusion training CLI (layoutllm_t2i_tpu/cli/
train_diffusion.py; GLIGEN/main.py equivalent).

Run on the card (one device; f32 throughout, the JAX CLI's default, on the
kernels' f32 forms; ``--mixed_precision`` computes the UNet in bf16 with
f32 master weights), on COCO-layout data (``DIR/train2014/`` and
``DIR/annotations/{instances,captions}_train2014.json``, data/coco.py) or
on synthetic batches:
  python -m layoutllm_t2i_torch.cli.train_diffusion --coco_root DIR --name exp
  python -m layoutllm_t2i_torch.cli.train_diffusion --synthetic --name exp
On the CPU, with tiny random models:
  python -m layoutllm_t2i_torch.cli.train_diffusion --small --synthetic \\
      --device cpu --batch_size 2 --total_iters 3 --save_every_iters 2 \\
      --warmup_steps 1
Data parallel, one process a device, under torchrun (``--batch_size`` is
the global batch; each rank loads its rows of it; ``--zero1`` splits the
Adam moments and the EMA over the ranks; ``--multihost`` insists on
torchrun's environment, the JAX flag's ``jax.distributed.initialize()``):
  torchrun --nproc_per_node 2 -m layoutllm_t2i_torch.cli.train_diffusion \
      --small --synthetic --device cpu --backend gloo --zero1 --multihost \
      --batch_size 4 --total_iters 3 --warmup_steps 1
Ranks that share one card take ``--device cuda:0 --backend gloo`` (NCCL
refuses two ranks on one device).
The flags are the JAX CLI's, plus ``--device`` and ``--backend``.
``--ckpt_path`` starts from a reference GLIGEN .pth (its embedded config
sets the geometry, so it takes the place of ``--small``'s models).
``--enable_previews`` writes a PLMS sample grid (``--preview_steps``) and
the batch's real images at every save.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from ..data.coco import coco_layout_batches
from ..data.synthetic import synthetic_layout_batches
from ..device import resolve_device
from ..models.clip_text import CLIPTextConfig, init_clip_text_params
from ..models.clip_tokenizer import HashTokenizer
from ..models.initializers import Init
from ..models.unet import UNetConfig, init_unet_params
from ..models.vae import VAEConfig, init_vae_params
from ..ops.schedules import make_ddpm_schedule
from ..parallel.mesh import BACKENDS, batch_rows, make_mesh, take_rows
from ..pipeline.inference import GligenModels
from ..training.diffusion_trainer import DiffusionTrainer, TrainerConfig
from ..utils.trees import ParamTree


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", type=str, default="relation_training")
    p.add_argument("--output_root", type=str, default="OUTPUT")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--total_iters", type=int, default=500_000)
    p.add_argument("--save_every_iters", type=int, default=5000)
    p.add_argument("--base_learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=10_000)
    p.add_argument("--scheduler_type", type=str, default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--trainable_mode", type=str, default="rela_fuse",
                   choices=["rela_fuse", "gligen", "all"])
    p.add_argument("--optimizer", type=str, default="adamw",
                   choices=["adamw", "sgd"],
                   help="sgd keeps zero optimizer state")
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--coco_root", type=str, default=None)
    p.add_argument("--image_size", type=int, default=512,
                   help="training image side; the UNet runs at the VAE's "
                        "latents (768: 96^2, SD-1.4's 24^2 sites at d 160)")
    p.add_argument("--max_boxes", type=int, default=30)
    p.add_argument("--max_relations", type=int, default=10)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--synthetic", action="store_true",
                   help="random data (smoke/benchmark runs)")
    p.add_argument("--multihost", action="store_true",
                   help="one process a device under torchrun's environment "
                        "(WORLD_SIZE, RANK, ...); raises without it")
    p.add_argument("--backend", type=str, default=None, choices=BACKENDS,
                   help="the group's backend (default: NCCL on the card, "
                        "gloo on the CPU; gloo where ranks share a card)")
    p.add_argument("--enable_previews", action="store_true",
                   help="PLMS sample grid at every save")
    p.add_argument("--preview_steps", type=int, default=50)
    p.add_argument("--export_reference_ckpt", action="store_true",
                   help="also write the reference 4-module .pth at every save")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 compute of the UNet with f32 master weights "
                        "(default: f32 throughout)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation microbatches per step "
                        "(batch_size is the effective batch)")
    p.add_argument("--enable_ema", action="store_true",
                   help="EMA of trainable params (reference enable_ema)")
    p.add_argument("--ema_rate", type=float, default=0.9999)
    p.add_argument("--sync_ckpt", action="store_true",
                   help="write checkpoints synchronously (default: disk "
                        "writes overlap training)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: the Adam moments and the EMA split over "
                        "the ranks")
    p.add_argument("--small", action="store_true",
                   help="tiny random models (CPU smoke)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (raises "
                        "without one)")
    return p.parse_args(argv)


def small_models(device) -> GligenModels:
    """Tiny random models: the JAX CLI's _small_models geometry
    (train_diffusion.py:70-93), weights from seed 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ini = Init(gen, dev, torch.float32)
    unet_cfg = UNetConfig(image_size=8, model_channels=32, num_res_blocks=1,
                          attention_resolutions=(2, 1), channel_mult=(1, 2),
                          num_heads=2, context_dim=32, grounding_in_dim=32,
                          grounding_out_dim=32)
    vae_cfg = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    clip_cfg = CLIPTextConfig(num_layers=1, hidden_size=32, num_heads=2,
                              intermediate_size=64, vocab_size=512)
    return GligenModels(
        unet_cfg=unet_cfg,
        unet_params=ParamTree(init_unet_params(ini, unet_cfg)),
        vae_cfg=vae_cfg, vae_params=ParamTree(init_vae_params(ini, vae_cfg)),
        clip_cfg=clip_cfg,
        clip_params=ParamTree(init_clip_text_params(ini, clip_cfg)),
        schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012),
        tokenizer=HashTokenizer(max_length=8, vocab_size=512),
        compute_dtype=torch.float32, device=dev)


def main(argv=None):
    args = parse_args(argv)
    missing = [k for k in ("WORLD_SIZE", "RANK") if k not in os.environ]
    if args.multihost and missing and not dist.is_initialized():
        raise RuntimeError(
            f"--multihost needs torchrun's environment: {', '.join(missing)} "
            "not set (run under torchrun --nproc_per_node N)")
    own_group = not dist.is_initialized()
    mesh = make_mesh(device=args.device, backend=args.backend)
    cfg = TrainerConfig(
        output_root=args.output_root, name=args.name, batch_size=args.batch_size,
        total_iters=args.total_iters, save_every_iters=args.save_every_iters,
        base_learning_rate=args.base_learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, scheduler_type=args.scheduler_type,
        trainable_mode=args.trainable_mode, optimizer=args.optimizer,
        max_boxes=args.max_boxes, max_relations=args.max_relations,
        seed=args.seed, ckpt_path=args.ckpt_path,
        disable_inference_in_training=not args.enable_previews,
        preview_steps=args.preview_steps,
        export_reference_ckpt=args.export_reference_ckpt,
        mixed_precision=args.mixed_precision,
        enable_ema=args.enable_ema, ema_rate=args.ema_rate,
        accum_steps=args.accum_steps, zero1_opt_state=args.zero1,
        async_ckpt=not args.sync_ckpt,
    )
    models = (small_models(mesh.device) if args.small and not args.ckpt_path
              else None)
    image_size = 16 if args.small else args.image_size  # small: f2 VAE, latent 8
    # each rank loads its rows of the global batch: COCO's loader takes the
    # rank's DistributedSampler slice of an epoch at batch_size / world;
    # synthetic runs take their rows of the one seeded global batch, so
    # they do not depend on the world size
    rows = batch_rows(cfg.batch_size, mesh, cfg.accum_steps)
    if args.coco_root and not args.synthetic:
        dataset = coco_layout_batches(args.coco_root, len(rows), image_size,
                                      cfg.max_boxes)
    else:
        dataset = (take_rows(b, rows) for b in synthetic_layout_batches(
            cfg.batch_size, image_size, cfg.max_boxes))
    try:
        trainer = DiffusionTrainer(cfg, dataset, models=models,
                                   device=mesh.device, mesh=mesh)
        try:
            trainer.train()
        finally:
            trainer.close()
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
