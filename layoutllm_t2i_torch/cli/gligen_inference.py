"""GLIGEN inference CLI, box + text grounding
(layoutllm_t2i_tpu/cli/gligen_inference.py, its box_text path; reference
gligen_inference.py:199-447).

Run: python -m layoutllm_t2i_torch.cli.gligen_inference \\
       --prompt "a dog" --layout "dog:[0.2,0.2,0.5,0.5]" [--ckpt c.pth] \\
       [--negative_prompt "blurry"] [--no_relation]
Offline smoke on the CPU: --small --device cpu. Writes sample_{i}.png with
the boxes drawn. The models run on the card unless --device says
otherwise; the noise comes from a torch.Generator seeded with --seed.

The other modalities (--modality other than box_text, --image_refs,
--map_path, --keypoints) and inpainting (--inpaint_image) raise
NotImplementedError before any model is built: ROADMAP.md Queue 1,
"Extra grounding, inpainting and the data loaders".
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from ..pipeline.inference import (InferencePipeline, convert_xywh_to_ltrb,
                                  images_to_uint8, parse_cfg_interval)
from ..pipeline.loaders import (load_models_from_gligen_ckpt,
                                quantize_unet_int8, random_models)
from ..pipeline.planner import extract_prediction
from ..pipeline.scene_graph import relation_texts_for_inference
from ..utils.boxes import draw_boxes_ltrb
from ..utils.images import save_png

NOT_PORTED = ("is not ported (ROADMAP.md Queue 1, \"Extra grounding, "
              "inpainting and the data loaders\")")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--layout", type=str, default=None,
                   help="'label:[x,y,w,h];...' normalized xywh "
                        "(required for box_text)")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--folder", type=str, default="gligen_samples")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--no_plms", action="store_true")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--alpha", type=float, nargs=3, default=[0.3, 0.0, 0.7])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--inpaint_image", type=str, default=None,
                   help="source image; layout boxes become the inpaint "
                        "region (not ported)")
    p.add_argument("--no_relation", action="store_true",
                   help="vanilla GLIGEN UNet (no relation-aware layer)")
    p.add_argument("--modality", default="box_text",
                   choices=["box_text", "text_image", "canny", "hed", "depth",
                            "normal", "sem", "keypoint"],
                   help="only box_text is ported")
    p.add_argument("--map_path", type=str, default=None,
                   help="condition-map image for the map modalities (not "
                        "ported)")
    p.add_argument("--image_refs", type=str, default=None,
                   help="text_image mode's reference images (not ported)")
    p.add_argument("--clip_vision_ckpt", type=str, default=None,
                   help="text_image mode's image tower (not ported)")
    p.add_argument("--projection_matrix", type=str, default=None,
                   help="text_image mode's reprojection (not ported)")
    p.add_argument("--keypoints", type=str, default=None,
                   help="keypoint mode's points (not ported)")
    p.add_argument("--small", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 UNet (ops/quant.py)")
    p.add_argument("--cache_encoder", type=int, default=0,
                   help="encoder propagation interval (arXiv:2312.09608)")
    p.add_argument("--cfg_interval", type=str, default=None,
                   help="LO,HI step fractions where CFG applies "
                        "(arXiv:2404.07724), e.g. 0.1,0.85 (paper-faithful: high-noise steps off)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Refuse what is not ported, before any model is built."""
    if args.modality != "box_text":
        raise NotImplementedError(f"--modality {args.modality} {NOT_PORTED}")
    for flag in ("image_refs", "map_path", "keypoints", "inpaint_image"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} {NOT_PORTED}")
    assert args.layout, "--layout is required for box_text"


def pipeline_settings(args) -> dict:
    """The InferencePipeline keywords the flags give."""
    steps = 250 if args.no_plms else 50
    if args.small:
        steps = min(steps, 8)
    return dict(steps=steps, sampler="ddim" if args.no_plms else "plms",
                guidance_scale=args.guidance_scale,
                alpha_type=tuple(args.alpha),
                encoder_cache_interval=args.cache_encoder,
                cfg_interval=parse_cfg_interval(args.cfg_interval))


def main(argv=None):
    args = parse_args(argv)
    check_supported(args)
    cats, boxes_xywh = extract_prediction(args.layout)
    boxes_ltrb = [convert_xywh_to_ltrb(b) for b in boxes_xywh]

    if args.ckpt:
        models = load_models_from_gligen_ckpt(args.ckpt, device=args.device)
    else:
        models = random_models(small=args.small, device=args.device)
    if args.no_relation:
        models.unet_cfg = dataclasses.replace(models.unet_cfg,
                                              use_relation_attention=False)
    if args.int8:
        models = quantize_unet_int8(models)
    pipe = InferencePipeline(models, **pipeline_settings(args))

    bs = args.batch_size
    rel = None
    if not args.no_relation:
        rel = [relation_texts_for_inference(args.prompt, models.max_relas)] * bs
    cond = pipe.build_cond([args.prompt] * bs, [(boxes_ltrb, cats)] * bs, rel)
    if args.negative_prompt:
        cond["uc_context"] = pipe.encode_text([args.negative_prompt] * bs)

    noise, gen = pipe._batch_noise(bs, args.seed)
    imgs = pipe.sample_latents(cond, noise, gen).cpu().numpy()

    os.makedirs(args.folder, exist_ok=True)
    paths = []
    for i, img in enumerate(images_to_uint8(imgs)):
        path = os.path.join(args.folder, f"sample_{i}.png")
        save_png(draw_boxes_ltrb(img, boxes_ltrb, cats), path)
        paths.append(path)
        print(f"saved {path}")
    return paths


if __name__ == "__main__":
    main()
