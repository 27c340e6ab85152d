"""COCO-NSS1K benchmark runner (layoutllm_t2i_tpu/eval/nss1k.py).

Evaluates layout-grounded generation over the 943-prompt COCO-NSS1K splits
(reference README.md:15-22; JSON files in the reference repo's data/
directory): Numerical 155 / Spatial 200 / Semantic 200 / Mixed 188 / Null
200. Reports, per split and overall:

  * mean CLIPScore (w=2.5 * max(cos, 0), eval/clip_score.py) from the
    reward's CLIP towers (pipeline/reward.py RewardModel, f32 on the card);
  * with ``--layout planner``: layout mIoU and DocSim of the planned layouts
    against the ground-truth ones (the Hungarian-matching math the composite
    reward uses, reference tools/metrics.py:58-164);
  * with ``--fid``: FID between generated and ground-truth images, pool3
    InceptionV3 features when an ``--inception_ckpt`` is given
    (eval/fid.py), else the CLIP vision tower ("clip_fid", labeled as such).

Runs without network: --layout gt needs no LLM, --layout planner works
offline with --layout_cache. On the card by default; ``--device cpu`` for a
CPU run (tiny models: ``--small``):

  python -m layoutllm_t2i_torch.eval.nss1k --data_path split.json \\
      --small --device cpu --steps 2 --batch_size 2

The flags are the JAX CLI's, plus ``--device``. ``--sharded`` splits each
generation batch's rows over every rank of the torchrun group
(generate_sharded; ``torchrun --nproc_per_node N -m
layoutllm_t2i_torch.eval.nss1k --sharded ...``): a ragged tail chunk is
padded to ``--batch_size`` with its last example and the padding's images
dropped, and only rank 0 prints. ``--batch_size`` must divide over the
ranks, which is checked before any model is built. The JAX CLI's
persistent XLA compile cache has no counterpart here. Ground-truth images
for ``--fid`` are read without Pillow when they are 8-bit RGB PNGs at the
generation size, as utils/images.py writes them; any other image needs
Pillow and raises without it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# split name -> reference data file (five_category.json is their union)
SPLIT_FILES = {
    "numerical": "only_numeral.json",
    "spatial": "sampled_only_spatial.json",
    "semantic": "sampled_only_semantic.json",
    "mixed": "mix_relation.json",
    "null": "sampled_non_relation.json",
}


def _host(a) -> np.ndarray:
    """Features as a host array, from a tensor on any device or an array."""
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def load_split(path: str):
    with open(path) as f:
        data = json.load(f)
    # NSS1K split files are bare lists; RL sample files wrap in {"data": ...}
    return data["data"] if isinstance(data, dict) else data


def gt_layout_ltrb(example):
    boxes = []
    for xc, yc, w, h in example["bbox"]:
        boxes.append([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2])
    return boxes, list(example["label"])


def gt_layout_xywh(example):
    """Top-left xywh, the coordinate convention the layout metrics use
    (reward path: center2lefttop, train_rl.py:64-66)."""
    boxes = []
    for xc, yc, w, h in example["bbox"]:
        boxes.append([xc - w / 2, yc - h / 2, w, h])
    return boxes, list(example["label"])


def layout_metrics(reward_model, layouts_pred, layouts_gt):
    """(miou, docsim) arrays; open-vocab predicted labels snap to the nearest
    COCO-80 class exactly as the reward does (models/policy.py:84-103)."""
    from .metrics import compute_docsim, compute_maximum_iou

    pred_ids = reward_model._layout_ids(layouts_pred, close_set=True)
    gt_ids = reward_model._layout_ids(layouts_gt, close_set=False)
    return compute_maximum_iou(gt_ids, pred_ids), compute_docsim(gt_ids, pred_ids)


def run_bench(
    pipe,
    reward_model,
    examples: List[dict],
    batch_size: int = 4,
    seed: int = 42,
    max_examples: Optional[int] = None,
    planner_fn: Optional[Callable[[List[str]], list]] = None,
    collect_images: bool = False,
    mesh=None,
) -> Dict:
    """One split. ``planner_fn(captions) -> [(categories, boxes_xywh), ...]``
    switches from GT layouts to planned ones (and adds mIoU/DocSim vs GT);
    ``collect_images`` returns the generated images for FID. A ragged tail
    chunk is generated at its own batch, or, with a ``mesh``
    (prompt-parallel over its ranks), padded to ``batch_size`` with its
    last example and the padding's images sliced off (nss1k.py:118-126 in
    the JAX package)."""
    from ..pipeline.inference import convert_xywh_to_ltrb
    from ..pipeline.scene_graph import relation_texts_for_inference
    from .clip_score import clip_score

    if max_examples:
        examples = examples[:max_examples]
    scores, times, imgs_all = [], [], []
    miou_all, docsim_all = [], []
    for i in range(0, len(examples), batch_size):
        chunk = examples[i : i + batch_size]
        captions = [ex["captions"] for ex in chunk]
        if planner_fn is None:
            layouts = [gt_layout_ltrb(ex) for ex in chunk]
        else:
            planned = planner_fn(captions)
            layouts = [([convert_xywh_to_ltrb(b) for b in boxes], cats)
                       for cats, boxes in planned]
            pred_xywh = [(boxes, cats) for cats, boxes in planned]
            gt_xywh = [gt_layout_xywh(ex) for ex in chunk]
            # metric pairs only where the planner produced any layout (the
            # reference drops unparseable generations, train_rl.py:72-76)
            pairs = [(p, g) for p, g in zip(pred_xywh, gt_xywh) if len(p[0])]
            if pairs:
                miou, docsim = layout_metrics(
                    reward_model, [p for p, _ in pairs], [g for _, g in pairs])
                miou_all.extend(miou.tolist())
                docsim_all.extend(docsim.tolist())
        rel = [relation_texts_for_inference(c, pipe.models.max_relas)
               for c in captions]
        t0 = time.perf_counter()
        # generate returns host images, so the device has finished
        if mesh is not None:
            pad = batch_size - len(captions)
            imgs = pipe.generate_sharded(
                mesh, captions + [captions[-1]] * pad,
                layouts + [layouts[-1]] * pad,
                relation_texts=rel + [rel[-1]] * pad,
                seed=seed + i)[:len(captions)]
        else:
            imgs = pipe.generate(captions, layouts, relation_texts=rel,
                                 seed=seed + i)
        times.append(time.perf_counter() - t0)
        if collect_images:
            imgs_all.append(np.asarray(imgs))
        img_feat = _host(reward_model.image_features(imgs))
        txt_feat = _host(reward_model.text_features(captions))
        scores.extend(clip_score(img_feat, txt_feat).tolist())

    out = {
        "n": len(scores),
        "clip_score_mean": float(np.mean(scores)),
        "sec_per_image": float(np.sum(times) / max(len(scores), 1)),
    }
    if planner_fn is not None:
        out["layout_miou"] = float(np.mean(miou_all)) if miou_all else 0.0
        out["layout_docsim"] = float(np.mean(docsim_all)) if docsim_all else 0.0
        out["layout_parsed"] = len(miou_all)
    if collect_images:
        out["images"] = np.concatenate(imgs_all, axis=0) if imgs_all else None
    return out


def run_all_splits(pipe, reward_model, data_dir: str, **kwargs) -> Dict:
    """All five NSS1K splits + an n-weighted overall row."""
    results: Dict[str, Dict] = {}
    for name, fname in SPLIT_FILES.items():
        path = os.path.join(data_dir, fname)
        if not os.path.exists(path):
            continue
        results[name] = run_bench(pipe, reward_model, load_split(path), **kwargs)
        results[name].pop("images", None)
    if results:
        total = sum(r["n"] for r in results.values())
        overall = {"n": total}
        for key in ("clip_score_mean", "sec_per_image", "layout_miou",
                    "layout_docsim"):
            vals = [(r[key], r["n"]) for r in results.values() if key in r]
            if vals:
                overall[key] = float(sum(v * n for v, n in vals)
                                     / sum(n for _, n in vals))
        results["overall"] = overall
    return results


def load_gt_images(examples: List[dict], img_dir: str, size: int = 512):
    """GT COCO images resized to the generation size, float [0,1]: Pillow's
    bicubic resize, as the JAX runner's, in numpy (utils/resample.py). An
    8-bit RGB PNG with unfiltered rows (utils/images.py's form) is read
    without Pillow; any other image is decoded by Pillow, and raises
    without it (utils/images.py read_rgb)."""
    from ..utils.images import read_rgb
    from ..utils.resample import resize_bicubic

    out = []
    for ex in examples:
        pixels = read_rgb(os.path.join(img_dir, ex["name"]))
        out.append(resize_bicubic(pixels, (size, size)).astype(np.float32)
                   / 255.0)
    return np.stack(out)


def compute_fid(gen_images, gt_images, inception_ckpt: Optional[str] = None,
                reward_model=None, batch: int = 16, device=None) -> Dict:
    """FID between image sets; InceptionV3 pool3 when a checkpoint is given
    (loaded on ``device``, None: the card), else CLIP vision features
    (labeled clip_fid).

    Refuses to score with a randomly initialized Inception: a Fréchet
    distance over random features is not a metric, so callers without
    weights get an error instead of a meaningless number."""
    from .fid import (compute_stats, frechet_distance, inception_features,
                      load_inception_checkpoint)

    if inception_ckpt:
        params = load_inception_checkpoint(inception_ckpt, device=device)
        fa = inception_features(params, gen_images, batch)
        fb = inception_features(params, gt_images, batch)
        key = "fid"
    elif reward_model is not None:
        fa = _host(reward_model.image_features(gen_images))
        fb = _host(reward_model.image_features(gt_images))
        key = "clip_fid"
    else:
        raise ValueError(
            "FID needs real features: pass --inception_ckpt (pytorch-fid's "
            "pt_inception or torchvision's inception_v3 weights) or a reward "
            "model with CLIP vision weights. Refusing to score with a "
            "randomly initialized Inception."
        )
    return {key: frechet_distance(*compute_stats(fa), *compute_stats(fb))}


def resolve_fast_preset(args):
    """--fast on the quality gate = score exactly what `serve --fast`
    serves. Maps this CLI's arg surface (steps default 50, not None) onto
    pipeline/presets.py apply_fast_preset: an explicit non-default --steps
    wins; the default 50 becomes the preset's steps when it flips the
    sampler."""
    from ..pipeline.presets import apply_fast_preset

    if args.steps == 50:  # argparse default → let the preset choose
        args.steps = None
    apply_fast_preset(args)
    if args.steps is None:  # preset left it alone (explicit --sampler)
        args.steps = 50
    return args


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", type=str, default=None,
                    help="single split JSON (e.g. five_category.json)")
    ap.add_argument("--data_dir", type=str, default=None,
                    help="directory with the five NSS1K split files")
    ap.add_argument("--diff_ckpt", type=str, default=None)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--max_examples", type=int, default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--layout", choices=["gt", "planner"], default="gt")
    ap.add_argument("--layout_cache", type=str, default=None,
                    help="offline LLM cache for --layout planner")
    ap.add_argument("--policy_ckpt", type=str, default=None)
    ap.add_argument("--cand_data_dir", type=str, default="./data")
    ap.add_argument("--cand_number", type=int, default=32)
    ap.add_argument("--shot_number", type=int, default=2)
    ap.add_argument("--fid", action="store_true")
    ap.add_argument("--img_dir", type=str, default=None,
                    help="GT COCO image dir (required for --fid)")
    ap.add_argument("--inception_ckpt", type=str, default=None,
                    help="torchvision/pytorch-fid inception_v3 .pth")
    ap.add_argument("--clip_ckpt", type=str, default=None,
                    help="full CLIPModel .pth for the scoring towers")
    ap.add_argument("--aesthetic_ckpt", type=str, default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="shard each generation batch over every rank of "
                         "the torchrun group")
    ap.add_argument("--cfg_interval", type=str, default=None,
                    help="LO,HI step fractions where CFG applies "
                         "(arXiv:2404.07724)")
    ap.add_argument("--cache_encoder", type=int, default=0,
                    help="encoder propagation interval (arXiv:2312.09608)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 UNet (ops/quant.py)")
    ap.add_argument("--sampler", type=str, default="plms",
                    choices=["plms", "ddim", "dpm"])
    ap.add_argument("--fast", action="store_true",
                    help="score the exact `serve --fast` preset "
                         "(pipeline/presets.py); explicit flags override "
                         "its pieces")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the CUDA card (raises "
                         "without one)")
    return ap.parse_args(argv)


def build_planner(args, reward):
    """``planner_fn`` of --layout planner: policy scores of the captions
    against the candidate captions (the reward's text features), top-k
    shots, the layout LLM (offline from --layout_cache)."""
    from ..cli.txt2img import load_policy
    from ..data.rl_data import load_rl_data
    from ..models.initializers import Init
    from ..models.policy import init_policy_params, policy_scores
    from ..pipeline.planner import CachedLayoutLLM, LLMClient, plan_layouts

    llm = (CachedLayoutLLM(args.layout_cache) if args.layout_cache
           else LLMClient())
    _, cand_examples, _, _ = load_rl_data(args.cand_data_dir, 1,
                                          args.cand_number)
    dev = reward.device
    if args.policy_ckpt:
        policy_params = load_policy(args.policy_ckpt, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        policy_params = init_policy_params(Init(gen, dev, torch.float32))
    feats_cand = reward.text_features([d["captions"] for d in cand_examples])

    def planner_fn(captions):
        feats = reward.text_features(captions)
        with torch.no_grad():
            scores = _host(policy_scores(policy_params, feats, feats_cand))
        planned = plan_layouts(llm, scores, cand_examples, captions,
                               shot_number=args.shot_number)
        return [(cats, boxes) for cats, boxes, _out, _ids in planned]

    return planner_fn


def main(argv=None):
    """Prints the result as one JSON line and returns it."""
    args = parse_args(argv)
    if not (args.data_path or args.data_dir):
        raise SystemExit("nss1k: need --data_path or --data_dir")
    mesh = None
    if args.sharded:
        from ..parallel.mesh import make_mesh, row_block

        mesh = make_mesh(device=args.device)
        row_block(args.batch_size, mesh)   # raises before any model
        args.device = mesh.device
    if args.fast:
        resolve_fast_preset(args)

    from ..cli.train_rl import build_reward
    from ..parallel.mesh import is_primary
    from ..pipeline.inference import InferencePipeline, parse_cfg_interval
    from ..pipeline.loaders import (load_models_from_gligen_ckpt,
                                    quantize_unet_int8, random_models)

    models = (load_models_from_gligen_ckpt(args.diff_ckpt, device=args.device)
              if args.diff_ckpt
              else random_models(small=args.small, device=args.device))
    if args.int8:
        models = quantize_unet_int8(models)
    pipe = InferencePipeline(models, steps=args.steps, sampler=args.sampler,
                             guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
                             encoder_cache_interval=args.cache_encoder,
                             cfg_interval=parse_cfg_interval(args.cfg_interval))
    reward_args = argparse.Namespace(small=args.small, clip_ckpt=args.clip_ckpt,
                                     aesthetic_ckpt=args.aesthetic_ckpt)
    reward = build_reward(reward_args, device=args.device)
    planner_fn = build_planner(args, reward) if args.layout == "planner" else None

    kwargs = dict(batch_size=args.batch_size, seed=args.seed,
                  max_examples=args.max_examples, planner_fn=planner_fn,
                  mesh=mesh)
    if args.data_dir:
        out = run_all_splits(pipe, reward, args.data_dir, **kwargs)
    else:
        examples = load_split(args.data_path)
        out = run_bench(pipe, reward, examples, collect_images=args.fid,
                        **kwargs)
        if args.fid:
            if not args.img_dir:
                raise SystemExit("nss1k: --fid needs --img_dir with the GT images")
            gen = out.pop("images")
            n = len(gen)
            gt = load_gt_images(examples[:n], args.img_dir, size=gen.shape[1])
            # the reward model scores FID only with real CLIP vision weights:
            # a random-weight reward (no --clip_ckpt) would feed the same
            # meaningless features compute_fid refuses
            fid_reward = reward if args.clip_ckpt else None
            out.update(compute_fid(gen, gt, args.inception_ckpt, fid_reward,
                                   device=args.device))
        out.pop("images", None)
    if is_primary():
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
