"""Generation CLI with reference txt2img.py flag parity
(layoutllm_t2i_tpu/cli/txt2img.py).

prompt -> policy example selection -> LLM layout (or --layout_cache JSON /
--layout 'obj:[x,y,w,h];...' for offline runs) -> relation-aware diffusion
-> 512px images with box overlays, written as PNG (the JAX CLI writes JPEG
through Pillow; the port's writer is utils/images.py's).

Run: python -m layoutllm_t2i_torch.cli.txt2img --prompt "..." --cand_path ... \\
     --diff_ckpt_path ckpt.pth [--policy_ckpt_path p.pt] [--num_per_prompt 5]
Offline smoke on the CPU: --small --device cpu --layout "dog:[0.1,0.2,0.5,0.6]".
The models run on the card unless --device says otherwise. The noise comes
from a torch.Generator seeded with --seed + i, so images differ from the
JAX CLI's (jax.random) for the same seed.

Under torchrun (``torchrun --nproc_per_node N -m
layoutllm_t2i_torch.cli.txt2img ...``), where the world divides
num_per_prompt x batch_size, the whole sweep is one prompt-parallel batch
(generate_sharded, seed --seed) split over the ranks, as the JAX CLI shards
it over its devices (num_per_prompt is the reference's data-parallel
axis); otherwise every rank runs the loop. Only rank 0 prints and writes.
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from ..data.rl_data import load_json
from ..parallel.mesh import is_primary, make_mesh
from ..pipeline.inference import (InferencePipeline, convert_xywh_to_ltrb,
                                  images_to_uint8, parse_cfg_interval)
from ..pipeline.loaders import (load_models_from_gligen_ckpt,
                                quantize_unet_int8, random_models)
from ..pipeline.planner import (CachedLayoutLLM, LLMClient, build_prompt,
                                extract_prediction, select_topk_shots)
from ..pipeline.scene_graph import relation_texts_for_inference
from ..utils.boxes import draw_boxes_ltrb
from ..utils.images import save_png


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--folder", type=str, default="generation_samples")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_per_prompt", type=int, default=5)
    p.add_argument("--no_plms", action="store_true", help="use DDIM-250 instead")
    p.add_argument("--sampler", type=str, default=None,
                   choices=["plms", "ddim", "dpm"],
                   help="override the sampler (dpm = DPM-Solver++(2M), "
                        "pair with --sample_steps)")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="override the step count (e.g. 20 with --sampler dpm)")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--in_dim", type=int, default=768)
    p.add_argument("--embedding_size", type=int, default=128)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--cand_path", type=str, default=None)
    p.add_argument("--policy_ckpt_path", type=str, default=None)
    p.add_argument("--diff_ckpt_path", type=str, default=None,
                   help="GLIGEN .pth; omit for random weights (smoke)")
    p.add_argument("--sd_conv_path", type=str, default=None)
    p.add_argument("--shot_number", type=int, default=2)
    # LLM settings (engine flags mirror train_rl.py)
    p.add_argument("--engine", type=str, default="gpt-3.5-turbo")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max_tokens", type=int, default=512)
    p.add_argument("--presence_penalty", type=float, default=0.0)
    p.add_argument("--frequency_penalty", type=float, default=0.0)
    # offline modes
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="full CLIPModel .pth for policy text features "
                        "(projected get_text_features, exact reference parity); "
                        "falls back to the pipeline text encoder's pooled output")
    p.add_argument("--layout_cache", type=str, default=None,
                   help="JSON caption->layout cache; replaces the LLM call")
    p.add_argument("--layout", type=str, default=None,
                   help="explicit layout 'label:[x,y,w,h];label:[...]' (xywh)")
    p.add_argument("--small", action="store_true", help="tiny random models (CI smoke)")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 UNet (ops/quant.py); "
                        "LLT2I_FFN_INT8=1 routes its FF sites to K7")
    p.add_argument("--cache_encoder", type=int, default=0,
                   help="encoder propagation interval (approximate speed "
                        "mode, arXiv:2312.09608; 0/1 = exact)")
    p.add_argument("--cfg_interval", type=str, default=None,
                   help="LO,HI step fractions where CFG applies "
                        "(arXiv:2404.07724), e.g. 0.1,0.85 (paper-faithful: high-noise steps off)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card")
    return p.parse_args(argv)


def load_policy(path: str, device):
    """Policy params from a reference ``.pt``/``.pth`` (a bare nn.Linear
    state_dict) or a pickled JAX policy tree (through the weights
    bridge)."""
    if path.endswith((".pt", ".pth")):
        from ..checkpoint import convert

        linear = convert.load_policy(path)["linear"]
        return {"linear": {k: v.to(device=device, dtype=torch.float32)
                           for k, v in linear.items()}}
    import pickle

    from ..checkpoint.from_jax import policy_params_from_jax

    with open(path, "rb") as f:
        return policy_params_from_jax(pickle.load(f), device=device)


def plan_layout(args):
    """Returns (categories, boxes_xywh)."""
    if args.layout:
        return extract_prediction(args.layout)

    cand_examples = load_json(args.cand_path)["data"]
    if args.layout_cache:
        llm = CachedLayoutLLM(args.layout_cache)
    else:
        llm = LLMClient(engine=args.engine, temperature=args.temperature,
                        max_tokens=args.max_tokens,
                        presence_penalty=args.presence_penalty,
                        frequency_penalty=args.frequency_penalty)

    # policy scoring over candidate captions needs CLIP text features: the
    # projected ones of a CLIPModel (--clip_ckpt), else the pooled output of
    # the pipeline's encoder
    shots = list(range(min(args.shot_number, len(cand_examples))))[::-1]
    if args.policy_ckpt_path and os.path.exists(args.policy_ckpt_path):
        from ..models.policy import policy_scores

        feats = _caption_features(
            [args.prompt] + [ex["captions"] for ex in cand_examples], args)
        params = load_policy(args.policy_ckpt_path, feats.device)
        with torch.no_grad():
            scores = policy_scores(params, feats[:1].float(),
                                   feats[1:].float())[0].cpu().numpy()
        shots = select_topk_shots(scores, args.shot_number)

    shot_cand = [cand_examples[c] for c in shots]
    output = llm(build_prompt(shot_cand, args.prompt))
    return extract_prediction(output)


def _caption_features(texts, args) -> torch.Tensor:
    """CLIP text features for policy scoring, on the pipeline's device.
    With --clip_ckpt the projected get_text_features (reference
    txt2img.py:454-457), computed in f32 whatever the pipeline's compute
    dtype, as the JAX CLI computes them: top-k shot selection on bf16
    scores could pick other shots. Otherwise the pipeline text encoder's
    pooled output (same dim, unprojected)."""
    pipe = _get_pipe(args)
    if getattr(args, "clip_ckpt", None):
        from ..checkpoint.convert import load_clip_text_model
        from ..models.clip_text import clip_text_features

        dev = pipe.models.device
        params, cfg = load_clip_text_model(args.clip_ckpt, device=dev,
                                           dtype=torch.float32)
        ids = torch.from_numpy(pipe.models.tokenizer(texts).astype(np.int64))
        with torch.no_grad():
            return clip_text_features(params, cfg, ids.to(dev))
    return pipe.encode_pooled(texts)


def pipeline_settings(args) -> dict:
    """The InferencePipeline keywords the flags give (JAX _get_pipe)."""
    steps = 250 if args.no_plms else 50
    sampler = "ddim" if args.no_plms else "plms"
    if getattr(args, "sampler", None):
        sampler = args.sampler
    if getattr(args, "sample_steps", None):
        steps = args.sample_steps
    return dict(steps=steps, sampler=sampler,
                guidance_scale=args.guidance_scale, alpha_type=(0.3, 0.0, 0.7),
                encoder_cache_interval=getattr(args, "cache_encoder", 0),
                cfg_interval=parse_cfg_interval(getattr(args, "cfg_interval", None)))


def _get_pipe(args) -> InferencePipeline:
    """The pipeline of these flags, built once per parsed ``args``."""
    pipe = getattr(args, "_pipe", None)
    if pipe is None:
        if args.diff_ckpt_path:
            models = load_models_from_gligen_ckpt(
                args.diff_ckpt_path, args.sd_conv_path, device=args.device)
        else:
            models = random_models(small=args.small, device=args.device)
        if getattr(args, "int8", False):
            models = quantize_unet_int8(models)
        pipe = args._pipe = InferencePipeline(models, **pipeline_settings(args))
    return pipe


def sweep_mesh(args):
    """The torchrun group when it has more than one rank and divides the
    sweep (num_per_prompt x batch_size), else None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and (args.num_per_prompt * args.batch_size) % world == 0:
        return make_mesh(device=args.device)
    return None


def main(argv=None):
    args = parse_args(argv)
    np.random.seed(args.seed)
    mesh = sweep_mesh(args)
    if mesh is not None:
        args.device = mesh.device
    primary = is_primary()

    categories, boxes_xywh = plan_layout(args)
    boxes_ltrb = [convert_xywh_to_ltrb(b) for b in boxes_xywh]
    if primary:
        print(f"layout: {list(zip(categories, [list(map(lambda v: round(v, 2), b)) for b in boxes_ltrb]))}")

    pipe = _get_pipe(args)
    rel = relation_texts_for_inference(args.prompt, pipe.models.max_relas)

    safe = re.sub(r"[^\w\s-]", "", args.prompt)[:100]
    if mesh is not None:
        total = args.num_per_prompt * args.batch_size
        batches = [pipe.generate_sharded(
            mesh, [args.prompt] * total, [(boxes_ltrb, categories)] * total,
            relation_texts=[rel] * total, seed=args.seed)]
    else:
        batches = (pipe.generate(
            [args.prompt] * args.batch_size,
            [(boxes_ltrb, categories)] * args.batch_size,
            relation_texts=[rel] * args.batch_size,
            seed=args.seed + i) for i in range(args.num_per_prompt))
    if primary:
        os.makedirs(args.folder, exist_ok=True)
    paths = []
    for imgs in batches:
        for img in images_to_uint8(imgs):
            path = os.path.join(args.folder, f"{safe}_{len(paths)}.png")
            paths.append(path)
            if primary:
                save_png(draw_boxes_ltrb(img, boxes_ltrb, categories), path)
                print(f"saved {path}")
    return paths


if __name__ == "__main__":
    main()
