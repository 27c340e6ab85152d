"""Multi-modality GLIGEN inference CLI (layoutllm_t2i_tpu/cli/
gligen_inference.py; reference gligen_inference.py:199-447).

Box + text generation (default), box + text inpainting (--inpaint_image:
the layout's boxes are the region to paint, the rest is kept), the
condition-map modalities (--modality canny/hed/depth/normal/sem with
--map_path: ConvNeXt grounding tokens and the downsampler's extra input
channels), person keypoints (--modality keypoint --keypoints) and box +
text + image grounding (--modality text_image --image_refs).

Run: python -m layoutllm_t2i_torch.cli.gligen_inference \\
       --prompt "a dog" --layout "dog:[0.2,0.2,0.5,0.5]" [--ckpt c.pth] \\
       [--negative_prompt "blurry"] [--no_relation] [--inpaint_image img.png] \\
       [--modality canny --map_path edge.png] \\
       [--modality keypoint --keypoints "0.5,0.2;0.52,0.18;..."] \\
       [--modality text_image --image_refs "ref.png;-"]
Offline smoke on the CPU: --small --device cpu. Writes sample_{i}.png with
the boxes drawn. The models run on the card unless --device says
otherwise; the noise (and the inpainting blend's and the VAE posterior's)
comes from torch generators seeded with --seed.

Images are read without Pillow where they are 8-bit RGB PNGs with
unfiltered rows (utils/images.py read_png; the card's machine has no
Pillow), other files through Pillow. Condition maps and reference images
may have any size, since the models resize them; the inpainting source
must have the generation size (512^2, 16^2 under --small), where the JAX
CLI resizes it with Pillow.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..pipeline.inference import (InferencePipeline, convert_xywh_to_ltrb,
                                  images_to_uint8, parse_cfg_interval)
from ..pipeline.inpaint import draw_masks_from_boxes
from ..pipeline.loaders import (MAP_MODALITIES, adapt_models_for_modality,
                                load_models_from_gligen_ckpt, model_configs,
                                quantize_unet_int8, random_models)
from ..pipeline.planner import extract_prediction
from ..pipeline.scene_graph import relation_texts_for_inference
from ..utils.boxes import draw_boxes_ltrb
from ..utils.images import read_rgb, save_png


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
                   help="source image at the generation size; layout boxes "
                        "become the inpaint region")
    p.add_argument("--no_relation", action="store_true",
                   help="vanilla GLIGEN UNet (no relation-aware layer)")
    p.add_argument("--modality", default="box_text",
                   choices=["box_text", "text_image", "canny", "hed", "depth",
                            "normal", "sem", "keypoint"])
    p.add_argument("--map_path", type=str, default=None,
                   help="condition-map image for the map modalities")
    p.add_argument("--image_refs", type=str, default=None,
                   help="text_image mode: ';'-separated reference image paths"
                        " paired with the --layout boxes ('-' skips a box)")
    p.add_argument("--clip_vision_ckpt", type=str, default=None,
                   help="CLIP .pth (vision_model.*, visual_projection) for "
                        "the image-reference tower")
    p.add_argument("--projection_matrix", type=str, default=None,
                   help="the reference's 768x768 'projection_matrix' file "
                        "(interface.py:128) for after_reproject image feats")
    p.add_argument("--keypoints", type=str, default=None,
                   help="'x,y;x,y;...' normalized, 17 per person, persons "
                        "separated by '|'")
    p.add_argument("--small", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 UNet (ops/quant.py)")
    p.add_argument("--cache_encoder", type=int, default=0,
                   help="encoder propagation interval (arXiv:2312.09608); "
                        "off under inpainting")
    p.add_argument("--cfg_interval", type=str, default=None,
                   help="LO,HI step fractions where CFG applies "
                        "(arXiv:2404.07724), e.g. 0.1,0.85 (paper-faithful: high-noise steps off)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card")
    return p.parse_args(argv)


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def parse_keypoints(spec: str, max_persons: int):
    """'x,y;...|x,y;...' -> points (P*17, 2), masks (P*17,)."""
    points = np.zeros((max_persons * 17, 2), np.float32)
    masks = np.zeros((max_persons * 17,), np.float32)
    for pi, person in enumerate(spec.split("|")[:max_persons]):
        for ki, xy in enumerate(person.split(";")[:17]):
            try:
                x, y = (float(v) for v in xy.split(","))
            except ValueError:
                raise ValueError(
                    f"--keypoints: cannot parse '{xy}' — expected 'x,y' pairs "
                    "separated by ';' (17 per person, persons by '|')")
            points[pi * 17 + ki] = [x, y]
            masks[pi * 17 + ki] = 1.0
    return points, masks


def generation_size(unet_cfg, vae_cfg) -> int:
    """The image side: the latent side times the VAE's factor."""
    return unet_cfg.image_size * 2 ** (len(vae_cfg.ch_mult) - 1)


def check_inpaint_size(pixels: np.ndarray, size: int) -> None:
    """An inpainting source must have the generation size."""
    _require(pixels.shape[:2] == (size, size),
             f"inpaint image: want {size}x{size} (the generation size), got "
             f"{pixels.shape[1]}x{pixels.shape[0]}")


def read_inpaint_source(path: str, size: int) -> np.ndarray:
    """The inpainting source, (size, size, 3) uint8; another size raises."""
    pixels = read_rgb(path)
    check_inpaint_size(pixels, size)
    return pixels


def check_inputs(args):
    """Refuse bad modality inputs before any model is built (the JAX CLI's
    checks and messages, cli/gligen_inference.py:166-185, plus the
    inpainting source's size). Returns (cats, boxes_ltrb)."""
    box_mode = args.modality in ("box_text", "text_image")
    if box_mode:
        _require(bool(args.layout), f"--layout is required for {args.modality}")
        cats, boxes_xywh = extract_prediction(args.layout)
        boxes_ltrb = [convert_xywh_to_ltrb(b) for b in boxes_xywh]
        if args.modality == "text_image":
            _require(bool(args.image_refs),
                     "--image_refs is required for text_image")
            refs = args.image_refs.split(";")
            _require(len(refs) == len(boxes_ltrb),
                     f"--image_refs has {len(refs)} entries for "
                     f"{len(boxes_ltrb)} boxes ('-' skips a box)")
    else:
        cats, boxes_ltrb = [], []
        if args.modality == "keypoint":
            _require(bool(args.keypoints), "--keypoints is required for keypoint")
            parse_keypoints(args.keypoints, 8)  # fail fast on malformed input
        else:
            _require(bool(args.map_path),
                     f"--map_path is required for {args.modality}")
    if args.inpaint_image and not args.ckpt:
        read_inpaint_source(args.inpaint_image,
                            generation_size(*model_configs(args.small)[:2]))
    return cats, boxes_ltrb


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


def _vision_tower(args, device):
    """(params, config) of the image-reference tower, in f32: the
    --clip_vision_ckpt's, strictly by name, or random weights from --seed
    (a 2-layer tower under --small, ViT-L/14 otherwise)."""
    from ..models.clip_vision import CLIPVisionConfig, init_clip_vision_params
    from ..models.initializers import Init
    from ..utils.trees import ParamTree

    if args.clip_vision_ckpt:
        from ..checkpoint.convert import (_strict_module, _torch_load,
                                          clip_vision_config_of,
                                          clip_vision_model_state_dict)

        sd = clip_vision_model_state_dict(_torch_load(args.clip_vision_ckpt))
        cfg = clip_vision_config_of(sd)
        meta = Init(None, torch.device("meta"))
        return (_strict_module(init_clip_vision_params(meta, cfg), sd, device,
                               torch.float32), cfg)
    cfg = (CLIPVisionConfig(num_layers=2, hidden_size=64, num_heads=4,
                            intermediate_size=128, projection_dim=768)
           if args.small else CLIPVisionConfig())
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return ParamTree(init_clip_vision_params(Init(gen, device), cfg)), cfg


@torch.no_grad()
def image_ref_grounding(args, models, cond) -> dict:
    """text_image mode: a CLIP image embedding a box from its reference
    image ('-' leaves the box without one), rescaled 'after_reproject' to
    norm 28.7 (tsv_dataset.py:193), through --projection_matrix when one is
    given (data/tsv.py reproject_embedding)."""
    from ..data.tsv import reproject_embedding
    from ..models.clip_vision import clip_image_features, preprocess_images

    dev = models.device
    params, vision_cfg = _vision_tower(args, dev)
    proj = None
    if args.projection_matrix:
        proj = torch.load(args.projection_matrix, map_location="cpu",
                          weights_only=False).float().numpy()
    mo = cond["boxes"].shape[1]
    emb = np.zeros((args.batch_size, mo, 768), np.float32)
    image_masks = np.zeros((args.batch_size, mo), np.float32)
    for bi, ref in enumerate(args.image_refs.split(";")):
        if ref == "-":
            continue
        x = torch.from_numpy(read_rgb(ref).astype(np.float32)[None] / 255.0)
        pixels = preprocess_images(x.to(dev), vision_cfg)
        feat = clip_image_features(params, vision_cfg, pixels).float().cpu().numpy()[0]
        if proj is not None:
            feat = reproject_embedding(feat[None], proj)[0]
        else:
            feat = feat / max(np.linalg.norm(feat), 1e-6) * 28.7
        emb[:, bi] = feat
        image_masks[:, bi] = 1.0
    return {"text_masks": cond["masks"],
            "image_masks": torch.from_numpy(image_masks).to(dev),
            "image_embeddings": torch.from_numpy(emb).to(dev)}


def map_conditioning(models, cmap: torch.Tensor) -> dict:
    """The map modalities' conditioning from a (B, H, W, 3) map in [0, 1]:
    the tokenizer's map and mask, and the downsampler's extra input
    channels, computed once before sampling (the reference runs
    downsample_net every step, openaimodel.py:433)."""
    from ..models.grounding_extras import grounding_downsampler

    b = cmap.shape[0]
    with torch.no_grad():
        extra = grounding_downsampler(models.unet_params["downsample_net"], cmap,
                                      resize_input=4 * models.unet_cfg.image_size)
    return {"extra_grounding": {"cond_map": cmap,
                                "map_mask": torch.ones(b, device=cmap.device)},
            "grounding_extra": extra.float()}


def keypoint_conditioning(models, spec: str, b: int) -> dict:
    """Keypoint mode's boxes (the points), masks and zero phrase embeddings."""
    pts, masks = parse_keypoints(spec, models.unet_cfg.max_persons_per_image)
    dev = models.device
    return {"boxes": torch.from_numpy(pts)[None].repeat(b, 1, 1).to(dev),
            "masks": torch.from_numpy(masks)[None].repeat(b, 1).to(dev),
            "phrase_embeddings": torch.zeros(
                b, pts.shape[0], models.unet_cfg.grounding_in_dim, device=dev)}


@torch.no_grad()
def inpaint_conditioning(models, pixels: np.ndarray, boxes_ltrb, b: int,
                         seed: int) -> dict:
    """The blend's keep-mask (1 outside the boxes, at latent size) and z0,
    a VAE posterior sample of the source from a generator seeded with
    ``seed``; both NHWC. An inpaint_mode UNet also takes the masked latent
    and the mask as extra input channels, as the reference builds them
    (gligen_inference.py: ``cat([z0 * mask, mask])``); the JAX CLI sets
    no ``inpainting_extra``, so its inpaint_mode UNet has none to read."""
    from ..models.vae import encode as vae_encode
    from ..ops.nn import nchw_to_nhwc, nhwc_to_nchw

    dev = models.device
    x = torch.from_numpy(pixels.astype(np.float32) / 127.5 - 1.0)[None]
    x = nhwc_to_nchw(x.repeat(b, 1, 1, 1).to(dev).to(models.compute_dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    z0 = vae_encode(models.vae_params, models.vae_cfg, x, generator=gen,
                    sample=True)
    keep = draw_masks_from_boxes(np.asarray([boxes_ltrb] * b, np.float32),
                                 size=models.unet_cfg.image_size, seed=seed)
    out = {"inpaint_mask": torch.from_numpy(keep).to(dev),
           "inpaint_z0": nchw_to_nhwc(z0.float())}
    if models.unet_cfg.inpaint_mode:
        out["inpainting_extra"] = torch.cat(
            [out["inpaint_z0"] * out["inpaint_mask"], out["inpaint_mask"]], dim=-1)
    return out


def main(argv=None):
    args = parse_args(argv)
    cats, boxes_ltrb = check_inputs(args)
    box_mode = args.modality in ("box_text", "text_image")

    if args.ckpt:
        models = load_models_from_gligen_ckpt(args.ckpt, device=args.device)
    else:
        models = random_models(small=args.small, device=args.device)
    source = None
    if args.inpaint_image:
        source = read_inpaint_source(
            args.inpaint_image, generation_size(models.unet_cfg, models.vae_cfg))
    _require(source is not None or not models.unet_cfg.inpaint_mode,
             "an inpaint_mode checkpoint needs --inpaint_image")
    if args.no_relation:
        models.unet_cfg = dataclasses.replace(models.unet_cfg,
                                              use_relation_attention=False)
    if args.modality != "box_text":
        models = adapt_models_for_modality(models, args.modality, seed=args.seed)
        if not box_mode:
            # grounding stays on for all steps: the SD first-conv restore
            # cannot apply over the extra downsampler channels
            args.alpha = [1.0, 0.0, 0.0]
    if args.int8:
        models = quantize_unet_int8(models)
    pipe = InferencePipeline(models, **pipeline_settings(args))

    bs = args.batch_size
    rel = None
    if not args.no_relation and box_mode:
        rel = [relation_texts_for_inference(args.prompt, models.max_relas)] * bs
    cond = pipe.build_cond([args.prompt] * bs, [(boxes_ltrb, cats)] * bs, rel)
    if args.negative_prompt:
        cond["uc_context"] = pipe.encode_text([args.negative_prompt] * bs)

    if args.modality == "text_image":
        cond["extra_grounding"] = image_ref_grounding(args, models, cond)
    elif args.modality in MAP_MODALITIES:
        cmap = torch.from_numpy(read_rgb(args.map_path).astype(np.float32)[None]
                                / 255.0).repeat(bs, 1, 1, 1).to(models.device)
        cond.update(map_conditioning(models, cmap))
    elif args.modality == "keypoint":
        cond.update(keypoint_conditioning(models, args.keypoints, bs))
    if source is not None:
        cond.update(inpaint_conditioning(models, source, boxes_ltrb, bs,
                                         args.seed))

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
