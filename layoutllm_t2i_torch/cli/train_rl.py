"""REINFORCE policy-training CLI with train_rl.py flag parity
(layoutllm_t2i_tpu/cli/train_rl.py).

Run: python -m layoutllm_t2i_torch.cli.train_rl --img_dir .../train2014 \\
       --diff_ckpt ckpt.pth --clip_ckpt clip.pth --aesthetic_ckpt aes.pth \\
       [--layout_cache layouts.json for offline runs]
Offline smoke on the CPU: --small --device cpu --layout_cache l.json
--img_dir imgs --sampled_data_dir data. The models run on the card unless
--device says otherwise: the frozen GLIGEN pipeline in its compute dtype
(bf16 on the card), the reward's CLIP towers and aesthetic MLP in f32.
Without --clip_ckpt / --aesthetic_ckpt / --diff_ckpt their weights are
random (torch generators seeded 0), so they differ from the JAX CLI's.
"""
from __future__ import annotations

import argparse
import json
import os
from datetime import datetime

import numpy as np
import torch

from ..data.rl_data import RLBatches, load_rl_data
from ..device import resolve_device
from ..training.rl_trainer import RLConfig, RLTrainer
from ..utils.logging import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp", type=str, default="exp0")
    p.add_argument("--shot_number", type=int, default=2)
    p.add_argument("--seed", type=int, default=53)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--img_dir", type=str, required=True)
    p.add_argument("--sampled_data_dir", type=str, default="./data")
    p.add_argument("--train_number", type=int, default=64)
    p.add_argument("--cand_number", type=int, default=32)
    p.add_argument("--engine", type=str, default="gpt-3.5-turbo")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max_tokens", type=int, default=512)
    p.add_argument("--frequency_penalty", type=float, default=0.0)
    p.add_argument("--presence_penalty", type=float, default=0.0)
    p.add_argument("--model_config", type=str, default="openai/clip-vit-large-patch14")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_step_size", type=int, default=20)
    p.add_argument("--lr_gamma", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--embedding_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--policy_temperature", type=float, default=1.0)
    p.add_argument("--diff_ckpt", type=str, default=None)
    p.add_argument("--ckpt_root", type=str, default="./checkpoints")
    p.add_argument("--aesthetic_ckpt", type=str, default=None)
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="full CLIPModel .pth for the reward towers")
    p.add_argument("--layout_cache", type=str, default=None)
    p.add_argument("--small", action="store_true", help="tiny random models (smoke)")
    # rollout sampler config: the reference hardwires PLMS-50
    # (interface.py:313-320); --fast takes the serving preset instead
    p.add_argument("--sampler", type=str, default="plms",
                   choices=["plms", "ddim", "dpm"])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--cfg_interval", type=str, default=None)
    p.add_argument("--cache_encoder", type=int, default=0)
    p.add_argument("--fast", action="store_true",
                   help="rollout with the serving fast preset")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card")
    return p.parse_args(argv)


def build_reward(args, device=None):
    """The reward: tiny random towers with --small, full-width random ones
    (CLIP ViT-L/14 text and vision, the LAION aesthetic MLP), or the
    weights of --clip_ckpt / --aesthetic_ckpt; f32 on ``device``."""
    from ..checkpoint.convert import load_aesthetic, load_clip_model
    from ..models.clip_text import CLIPTextConfig, init_clip_text_params
    from ..models.clip_tokenizer import default_tokenizer
    from ..models.clip_vision import CLIPVisionConfig, init_clip_vision_params
    from ..models.initializers import Init, linear_p
    from ..models.policy import init_aesthetic_params
    from ..pipeline.reward import RewardModel

    dev = resolve_device(device)
    if args.small:
        text_cfg = CLIPTextConfig(num_layers=2)
        vision_cfg = CLIPVisionConfig(num_layers=2, hidden_size=64, num_heads=4,
                                      intermediate_size=128, projection_dim=768)
    else:
        text_cfg, vision_cfg = CLIPTextConfig(), CLIPVisionConfig()

    gen = torch.Generator(device=dev).manual_seed(0)
    ini = Init(gen, dev, torch.float32)
    if args.clip_ckpt:
        text_params, text_cfg, vision_params, vision_cfg = load_clip_model(
            args.clip_ckpt, device=dev)
    else:
        text_params = init_clip_text_params(ini, text_cfg)
        text_params["text_projection"] = linear_p(ini, text_cfg.hidden_size,
                                                  768, bias=False)
        vision_params = init_clip_vision_params(ini, vision_cfg)
    if args.aesthetic_ckpt:
        aes = load_aesthetic(args.aesthetic_ckpt, device=dev)
    else:
        aes = init_aesthetic_params(ini)
    return RewardModel(text_cfg, text_params, vision_cfg, vision_params, aes,
                       default_tokenizer(), device=dev)


def build_generate_fn(args, device=None):
    """The frozen GLIGEN pipeline and ``generate_fn(captions, layouts,
    seed)``: layouts in xywh with labels, a fresh seed per rollout."""
    from ..pipeline.inference import (InferencePipeline, convert_xywh_to_ltrb,
                                      parse_cfg_interval)
    from ..pipeline.loaders import load_models_from_gligen_ckpt, random_models
    from ..pipeline.presets import apply_fast_preset
    from ..pipeline.scene_graph import relation_texts_for_inference

    if args.diff_ckpt:
        models = load_models_from_gligen_ckpt(args.diff_ckpt, device=device)
    else:
        models = random_models(small=args.small, device=device)
    if args.fast:
        apply_fast_preset(args)
    pipe = InferencePipeline(
        models, steps=args.steps or 50, sampler=args.sampler,
        guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
        encoder_cache_interval=args.cache_encoder or None,
        cfg_interval=parse_cfg_interval(args.cfg_interval))

    def generate_fn(captions, layouts, seed=None):
        lay = [([convert_xywh_to_ltrb(b) for b in boxes], labels)
               for boxes, labels in layouts]
        rel = [relation_texts_for_inference(c, models.max_relas) for c in captions]
        # the trainer passes a fresh seed per rollout batch (reference draws
        # fresh noise per sample, interface.py:478-551)
        return pipe.generate(captions, lay, relation_texts=rel,
                             seed=args.seed if seed is None else seed)

    return generate_fn


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    args.exp = args.exp + datetime.now().strftime("_%Y_%m_%d_%H_%M_%S")
    ckpt_path = os.path.join(args.ckpt_root, args.exp)
    os.makedirs(ckpt_path, exist_ok=True)
    logger = Logger(os.path.join(ckpt_path, "log.txt"))
    logger.write(json.dumps(vars(args), indent=2))

    reward_model = build_reward(args, device)
    generate_fn = build_generate_fn(args, device)

    # LLM
    if args.layout_cache:
        from ..pipeline.planner import CachedLayoutLLM

        llm = CachedLayoutLLM(args.layout_cache)
    else:
        from ..pipeline.planner import LLMClient

        llm = LLMClient(engine=args.engine, temperature=args.temperature,
                        max_tokens=args.max_tokens,
                        presence_penalty=args.presence_penalty,
                        frequency_penalty=args.frequency_penalty,
                        logger=Logger(os.path.join(ckpt_path, "gpt_log.txt")))

    # data + caption features
    train_examples, cand_examples, _, _ = load_rl_data(
        args.sampled_data_dir, args.train_number, args.cand_number
    )
    feats_train = reward_model.text_features(
        [d["captions"] for d in train_examples]).cpu().numpy()
    feats_cand = reward_model.text_features(
        [d["captions"] for d in cand_examples]).cpu().numpy()
    batches = RLBatches(train_examples, args.img_dir, args.batch_size)

    cfg = RLConfig(
        epochs=args.epochs, batch_size=args.batch_size, shot_number=args.shot_number,
        lr=args.lr, lr_step_size=args.lr_step_size, lr_gamma=args.lr_gamma,
        policy_temperature=args.policy_temperature,
        embedding_size=args.embedding_size, seed=args.seed,
        ckpt_path=ckpt_path, resume=args.resume,
    )
    trainer = RLTrainer(cfg, reward_model, generate_fn, llm, train_examples,
                        cand_examples, feats_train, feats_cand, batches,
                        logger=logger, device=device)
    try:
        history = trainer.train()
    finally:
        trainer.close()
        logger.close()
    return ckpt_path, history


if __name__ == "__main__":
    main()
