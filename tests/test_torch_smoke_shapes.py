"""chip_smoke.py checks every kernel at the shapes that its main paths give
it, walked from the model configs. These tests hold that walk against the
kernel calls that a small model really makes on the CPU: one generation
and one training step, with every wrapper call recorded as chip_smoke
describes it, the kernel routes of ops/nn.py taken as for CUDA tensors.
The geometry is small but routes sites to K1 (32^2 latents: 1024 visual
tokens and 1054 with the grounding tokens; the VAE mid block at 32^2) and
leaves others on the plain path (16^2), as the full model does. Its 32
channels leave every feed-forward site below the fused FF kernels' width
(K3 and dense dots). One UNet forward of a 128-channel model at batch 1 is
held against the walk on every route that chip_smoke drives: its 32^2
feed-forward sites (1024 rows) are eligible for K4, K6, K7, K8a and K8b,
its 16^2 ones (256 rows) are not, as at full width the 8^2 middle block
is not.
"""
import collections
import contextlib
import dataclasses
import importlib
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
from layoutllm_t2i_torch.kernels.dispatch import needs_grad
from layoutllm_t2i_torch.models.clip_text import CLIPTextConfig, init_clip_text_params
from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
from layoutllm_t2i_torch.models.initializers import Init
from layoutllm_t2i_torch.models.unet import UNetConfig, init_unet_params, unet_apply
from layoutllm_t2i_torch.models.vae import VAEConfig, init_vae_params
from layoutllm_t2i_torch.ops import attention as attention_mod
from layoutllm_t2i_torch.ops import nn as nn_mod
from layoutllm_t2i_torch.ops.quant import quantize_params
from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule
from layoutllm_t2i_torch.pipeline.inference import GligenModels, InferencePipeline
from layoutllm_t2i_torch.training.diffusion_trainer import DiffusionTrainer, TrainerConfig
from layoutllm_t2i_torch.utils.trees import ParamTree
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()
LN = importlib.import_module("layoutllm_t2i_torch.kernels.layer_norm")
TOK_LEN = 8



def _models(channels=32, channel_mult=(1, 2)):
    gen = torch.Generator().manual_seed(0)
    ini = Init(gen, torch.device("cpu"), torch.float32)
    unet_cfg = UNetConfig(image_size=32, model_channels=channels, num_res_blocks=1,
                          attention_resolutions=(2, 1), channel_mult=channel_mult,
                          num_heads=2, context_dim=32, grounding_in_dim=32,
                          grounding_out_dim=32)
    vae_cfg = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    clip_cfg = CLIPTextConfig(num_layers=1, hidden_size=32, num_heads=2,
                              intermediate_size=64, vocab_size=512)
    return GligenModels(
        unet_cfg=unet_cfg, unet_params=ParamTree(init_unet_params(ini, unet_cfg)),
        vae_cfg=vae_cfg, vae_params=ParamTree(init_vae_params(ini, vae_cfg)),
        clip_cfg=clip_cfg, clip_params=ParamTree(init_clip_text_params(ini, clip_cfg)),
        schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012),
        tokenizer=HashTokenizer(max_length=TOK_LEN, vocab_size=512),
        compute_dtype=torch.float32, device="cpu")


class Calls(list):
    """The recorded calls; with ``mark_f32`` set, the args of a call on f32
    operands end in "f32", as chip_smoke's walk marks the kernels' f32
    forms (off by default: the CPU models of the other walks are f32 and
    stand for the card's bf16 ones)."""
    mark_f32 = False

    def add(self, kid, args, x):
        marked = self.mark_f32 and x.dtype is torch.float32
        self.append((kid, args + (("f32",) if marked else ())))


@pytest.fixture
def recorded(monkeypatch):
    """Every kernel wrapper call, as (kid, args) in chip_smoke's terms, with
    the routes taken as on the card."""
    calls = Calls()
    gn, ln = nn_mod._group_norm_rows, nn_mod._layer_norm_rows
    ff, fa = nn_mod.ffn_ln_geglu, attention_mod.flash_attention
    ff_res, ff_q = nn_mod.ffn_geglu, nn_mod.ffn_ln_geglu_q
    mm, geglu = nn_mod.linear_fused, nn_mod.geglu_fused
    label = lambda s: 1.0 if isinstance(s, float) and s == 1.0 else 0.5

    def group_norm(x, w, b, groups, eps, silu):
        calls.add("K2", (*x.shape, eps, silu), x)
        return gn(x, w, b, groups, eps, silu)

    def layer_norm(x, w, b, eps):
        # another eps than 1e-5 (ConvNeXt's 1e-6) is part of the shape
        calls.add("K3", tuple(x.shape) + ((eps,) if eps != 1e-5 else ()), x)
        return ln(x, w, b, eps)

    def ffn(x, lw, lb, w1, b1, w2, b2, s):
        calls.add("K4", (*x.shape, label(s)), x)
        return ff(x, lw, lb, w1, b1, w2, b2, s)

    def ffn_res(x, w1, b1, w2, b2, r):
        inner = w2.shape[1]
        calls.add("K6", tuple(x.shape) + (
            (inner,) if inner != 4 * x.shape[-1] else ()), x)
        return ff_res(x, w1, b1, w2, b2, r)

    def ffn_q(x, lw, lb, q1, s1, b1, q2, s2, b2, s):
        calls.add("K7", (*x.shape, label(s)), x)
        return ff_q(x, lw, lb, q1, s1, b1, q2, s2, b2, s)

    def linear(x, w, b=None, r=None):
        calls.add("K8a", (*x.shape, w.shape[0]), x)
        return mm(x, w, b, r)

    def geglu_proj(x, w, b=None):
        calls.add("K8b", (*x.shape, w.shape[0] // 2), x)
        return geglu(x, w, b)

    def flash(q, k, v, heads, scale):
        b, n, hc = q.shape
        args = (b, n, k.shape[1], heads, hc // heads)
        calls.add("K1", args + (("lse",) if needs_grad(q, k, v) else ()), q)
        return fa(q, k, v, heads, scale)

    monkeypatch.setattr(nn_mod, "_group_norm_rows", group_norm)
    monkeypatch.setattr(nn_mod, "_layer_norm_rows", layer_norm)
    monkeypatch.setattr(nn_mod, "ffn_ln_geglu", ffn)
    monkeypatch.setattr(nn_mod, "ffn_geglu", ffn_res)
    monkeypatch.setattr(nn_mod, "ffn_ln_geglu_q", ffn_q)
    monkeypatch.setattr(nn_mod, "linear_fused", linear)
    monkeypatch.setattr(nn_mod, "geglu_fused", geglu_proj)
    monkeypatch.setattr(nn_mod, "_on_card", lambda x: True)
    monkeypatch.setattr(attention_mod, "flash_attention", flash)
    return calls


def test_generation_walk_matches_the_calls(recorded):
    models = _models()
    pipe = InferencePipeline(models, steps=3, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=1)
    with torch.no_grad():
        pipe.generate(*cs.REQUESTS, seed=0)
    want = cs.generation_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                               TOK_LEN, cs.REQUESTS, vae_chunk=1)
    assert {kid for kid, _ in want} == {"K1", "K2", "K3"}
    # PLMS runs the UNet several times, with and without the gated fusers:
    # the walk covers each distinct call
    assert set(recorded) == set(want)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_bench_generation_walk_matches_the_calls(recorded, mode):
    """The bench's 8 requests: CFG batch 16 (exact), CFG 16 and cond-only 8
    with key and propagated steps (the fast preset's segments, here in 5
    steps), the VAE decoded in one chunk of 8."""
    models = _models()
    kw = {"exact": dict(steps=3),
          "fast": dict(steps=4, sampler="dpm", cfg_interval=(0.0, 0.75),
                       encoder_cache_interval=2)}[mode]
    pipe = InferencePipeline(models, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=cs.VAE_CHUNK, **kw)
    requests = cs.bench_requests()
    with torch.no_grad():
        pipe.generate(*requests, seed=0)
    evals = cs.unet_evaluations(pipe, cs.BENCH_BATCH)
    batches = {"exact": {16}, "fast": {8, 16}}[mode]
    assert {b for b, _, _ in evals} == batches
    want = cs.generation_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                               TOK_LEN, requests, cs.VAE_CHUNK, evals=evals)
    assert set(recorded) == set(want)
    # the VAE decodes the 8 latents in one chunk
    assert ("K2", (8, 64 * 64, 32, 1e-6, True)) in want
    # phase kernels walks the bench's own pipelines at the same batches
    bench = dict(zip(("exact", "fast"), cs.bench_pipelines(cs.tables_models())))
    assert {b for b, _, _ in cs.unet_evaluations(bench[mode], 8)} == batches


def test_cli_walk_matches_the_calls(recorded):
    """Phase cli's runs: one request with each layout (CFG batch 2), and the
    planner's CLIP features of the prompt and the candidates' captions."""
    from layoutllm_t2i_torch.pipeline.inference import convert_xywh_to_ltrb
    from layoutllm_t2i_torch.pipeline.planner import extract_prediction
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_inference

    models = _models()
    pipe = InferencePipeline(models, steps=3, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=cs.VAE_CHUNK)
    cached = "\n".join(f"{lab}: {box}" for lab, box in cs.CLI_CACHED_LAYOUT)
    with torch.no_grad():
        pipe.encode_pooled([cs.CLI_PLANNED_PROMPT]
                           + [c["captions"] for c in cs.CLI_CANDIDATES])
        for prompt, spec in ((cs.CLI_PROMPT, cs.CLI_LAYOUT),
                             (cs.CLI_PLANNED_PROMPT, cached)):
            cats, boxes = extract_prediction(spec)
            pipe.generate([prompt], [([convert_xywh_to_ltrb(b) for b in boxes], cats)],
                          [relation_texts_for_inference(prompt, 5)], seed=0)
    want = cs.cli_paths(models.unet_cfg, models.vae_cfg, models.clip_cfg, TOK_LEN)
    assert set(recorded) == set(want)
    assert ("K3", (8 * TOK_LEN, 32)) in want     # 6 texts, bucket 8


def test_rl_walk_matches_the_calls(recorded):
    """Phase rl's training run: the reward's 80 label embeddings, the train
    and candidate captions' features and one batch (the generation of its 4
    rollouts, CFG batch 8, then one reward call with one label outside
    COCO-80), its towers' LayerNorms in f32 (K3's f32 rows)."""
    from layoutllm_t2i_torch.models.clip_vision import (CLIPVisionConfig,
                                                        init_clip_vision_params)
    from layoutllm_t2i_torch.models.initializers import linear_p
    from layoutllm_t2i_torch.models.policy import init_aesthetic_params
    from layoutllm_t2i_torch.pipeline.planner import center2lefttop
    from layoutllm_t2i_torch.pipeline.reward import RewardModel

    models = _models()
    ini = Init(torch.Generator().manual_seed(1), torch.device("cpu"))
    text_cfg = CLIPTextConfig(num_layers=1, hidden_size=32, num_heads=2,
                              intermediate_size=64, vocab_size=512,
                              max_length=TOK_LEN)
    vision_cfg = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=32,
                                  num_layers=2, num_heads=2,
                                  intermediate_size=64, projection_dim=24)
    text = init_clip_text_params(ini, text_cfg)
    text["text_projection"] = linear_p(ini, 32, 24, bias=False)
    captions = [ex["captions"] for ex in cs.RL_TRAIN]
    reward = RewardModel(text_cfg, text, vision_cfg,
                         init_clip_vision_params(ini, vision_cfg),
                         init_aesthetic_params(ini, 24),
                         HashTokenizer(max_length=TOK_LEN, vocab_size=512),
                         device="cpu")
    reward.text_features(captions)
    reward.text_features([c["captions"] for c in cs.RL_CANDIDATES])
    n_setup = len(recorded)
    pipe = InferencePipeline(models, steps=3, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=cs.VAE_CHUNK)
    with torch.no_grad():
        imgs = pipe.generate(*cs.rl_requests(), seed=0)
    n_gen = len(recorded)
    pred = [([box for _, box in cs.RL_LAYOUTS[c]],
             [lab for lab, _ in cs.RL_LAYOUTS[c]]) for c in captions]
    gt = [(center2lefttop(ex["bbox"]), ex["label"]) for ex in cs.RL_TRAIN]
    reward(captions, imgs, imgs, pred, gt)
    f32 = recorded[:n_setup] + recorded[n_gen:]
    assert {kid for kid, _ in f32} == {"K3"}
    want = cs.rl_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                       text_cfg, vision_cfg, TOK_LEN)
    is_f32 = lambda c: c[0] == "K3" and len(c[1]) > 2
    want_f32 = [c for c in want if is_f32(c)]
    assert collections.Counter(cs.f32_calls(f32)) == collections.Counter(want_f32)
    assert set(recorded[n_setup:n_gen]) == {c for c in want if not is_f32(c)}
    assert ("K3", (4 * 5, 32, "f32")) in want_f32     # 4 images x 5 tokens
    assert ("K3", (TOK_LEN, 32, "f32")) in want_f32    # the one new label


def _small_reward():
    """A RewardModel with towers small enough for the CPU (f32, as on the
    card), and their configs."""
    from layoutllm_t2i_torch.models.clip_vision import (CLIPVisionConfig,
                                                        init_clip_vision_params)
    from layoutllm_t2i_torch.models.initializers import linear_p
    from layoutllm_t2i_torch.models.policy import init_aesthetic_params
    from layoutllm_t2i_torch.pipeline.reward import RewardModel

    ini = Init(torch.Generator().manual_seed(1), torch.device("cpu"))
    text_cfg = CLIPTextConfig(num_layers=1, hidden_size=32, num_heads=2,
                              intermediate_size=64, vocab_size=512,
                              max_length=TOK_LEN)
    vision_cfg = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=32,
                                  num_layers=2, num_heads=2,
                                  intermediate_size=64, projection_dim=24)
    text = init_clip_text_params(ini, text_cfg)
    text["text_projection"] = linear_p(ini, 32, 24, bias=False)
    reward = RewardModel(text_cfg, text, vision_cfg,
                         init_clip_vision_params(ini, vision_cfg),
                         init_aesthetic_params(ini, 24),
                         HashTokenizer(max_length=TOK_LEN, vocab_size=512),
                         device="cpu")
    return reward, text_cfg, vision_cfg


def _unmarked(calls):
    """A walk's calls with the f32 mark dropped (the CPU models of the
    generation and the reward's towers are all f32)."""
    return {(kid, args[:-1] if cs.is_f32(args) else args) for kid, args in calls}


def test_eval_walk_matches_the_calls(recorded, tmp_path):
    """Phase eval's runs through eval/nss1k.py run_bench: run A, each split
    under the fast preset at batch 2; run B, the planner's features of the
    candidates and the captions, the cached layouts (one label outside
    COCO-80) and the exact generation; CLIPScore after each batch. The
    reward's 80 label embeddings (made at construction) are phase rl's."""
    from layoutllm_t2i_torch.eval import nss1k

    models = _models()
    reward, text_cfg, vision_cfg = _small_reward()
    del recorded[:]
    fast = InferencePipeline(models, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=cs.VAE_CHUNK,
                             **{**cs.fast_settings(), "steps": 4})
    exact = InferencePipeline(models, steps=3, alpha_type=(0.3, 0.0, 0.7),
                              vae_chunk=cs.VAE_CHUNK)
    splits = {split: [{"captions": cap, "label": labels,
                       "bbox": cs.EVAL_BOXES[:len(labels)]} for cap, labels in items]
              for split, items in cs.EVAL_SPLITS.items()}
    for examples in splits.values():
        nss1k.run_bench(fast, reward, examples, batch_size=cs.EVAL_N)
    reward.text_features([c["captions"] for c in cs.CLI_CANDIDATES])
    examples = splits[cs.EVAL_FID_SPLIT]

    def planner_fn(captions):
        reward.text_features(captions)
        return [([lab for lab, _ in cs.EVAL_LAYOUTS[c]],
                 [b for _, b in cs.EVAL_LAYOUTS[c]]) for c in captions]

    out = nss1k.run_bench(exact, reward, examples, batch_size=cs.EVAL_N,
                          planner_fn=planner_fn)
    assert out["layout_parsed"] == cs.EVAL_N
    want = cs.eval_paths(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                         TOK_LEN, text_cfg, vision_cfg)
    assert set(recorded) == _unmarked(want)
    assert ("K3", (2 * 5, 32, "f32")) in want      # 2 images x 5 tokens
    assert ("K3", (len(cs.CLI_CANDIDATES) * TOK_LEN, 32, "f32")) in want


def test_preview_walk_matches_the_calls(recorded, tmp_path):
    """Phase train's preview under mixed precision: the trainer's f32 text
    encoder on the captions, the empty prompts and the grounding texts, the
    bf16 UNet at CFG batch 4, the bf16 VAE decode."""
    recorded.mark_f32 = True
    cfg = TrainerConfig(output_root=str(tmp_path), name="p", batch_size=2,
                        total_iters=1, max_boxes=cs.TRAIN_MAX_BOXES,
                        max_relations=cs.TRAIN_MAX_RELATIONS,
                        mixed_precision=True, preview_steps=2)
    trainer = DiffusionTrainer(cfg, iter(()), models=_models())
    batch = next(synthetic_layout_batches(2, 64, cs.TRAIN_MAX_BOXES))
    trainer.sample_previews(batch, 1)
    trainer.close()
    want = cs.preview_calls(trainer.models.unet_cfg, trainer.models.vae_cfg,
                            trainer.models.clip_cfg, TOK_LEN, batch)
    assert set(recorded) == set(want)
    assert any(kid == "K1" and not cs.is_f32(a) for kid, a in want)
    # the f32 calls are the text encoder's LayerNorms alone
    f32 = {kid for kid, a in want if cs.is_f32(a)}
    assert f32 == {"K3"}


def test_fast_generation_walk_matches_the_calls(recorded):
    """The fast preset (DPM-15, CFG on (0, 0.75), encoder cache 2): CFG
    steps at batch 4, cond-only steps at batch 2, the gated fusers on the
    first steps only, propagated steps without the encoder's calls."""
    models = _models()
    pipe = cs.fast_pipeline(models, vae_chunk=1)
    with torch.no_grad():
        pipe.generate(*cs.REQUESTS, seed=0)
    evals = cs.unet_evaluations(pipe, 2)
    assert {b for b, _, _ in evals} == {2, 4}
    assert {(gated, encoder) for _, gated, encoder in evals} == {
        (True, True), (True, False), (False, True), (False, False)}
    want = cs.generation_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                               TOK_LEN, cs.REQUESTS, vae_chunk=1, evals=evals)
    assert set(recorded) == set(want)
    # the walk from the tables alone, as phase kernels takes it
    assert cs.unet_evaluations(cs.fast_tables_pipeline(), 2) == evals


def test_unet_walk_models_the_gated_and_encoder_skips(recorded):
    """One UNet forward per (gated, encoder) case against its walk, as a
    list: the skip-gated body drops the fusers' calls, a propagated step
    the encoder's."""
    from layoutllm_t2i_torch.pipeline.inference import make_cfg_denoiser

    models = _models()
    cond = {"context": torch.zeros(2, TOK_LEN, 32), "uc_context": torch.zeros(2, TOK_LEN, 32),
            "boxes": torch.rand(2, 30, 4), "masks": torch.ones(2, 30),
            "phrase_embeddings": torch.zeros(2, 30, 32),
            "relations": torch.zeros(2, 5, 32)}
    x, t = torch.zeros(2, 4, 32, 32), torch.full((2,), 981)
    for cfg_on in (True, False):
        dn = make_cfg_denoiser(models, 7.5, cfg_override=cfg_on)
        with torch.no_grad():
            _, cache = dn(models.unet_params, None, cond, x, t, 1.0, False,
                          cache=None, is_key=True)
            for gated in (True, False):
                for encoder in (True, False):
                    recorded.clear()
                    dn(models.unet_params, None, cond, x, t, 1.0, False,
                       skip_gated=not gated, cache=cache, is_key=encoder)
                    want = cs.unet_calls(models.unet_cfg, 4 if cfg_on else 2, 30, 5,
                                         TOK_LEN, gated=gated, encoder=encoder)
                    assert recorded == want, (cfg_on, gated, encoder)


def _training_step(tmp_path, models=None, **kw):
    cfg = TrainerConfig(output_root=str(tmp_path), name="t", batch_size=2,
                        total_iters=1, warmup_steps=0, max_boxes=30,
                        max_relations=10, **kw)
    trainer = DiffusionTrainer(cfg, iter(()), models=models or _models())
    batch = next(synthetic_layout_batches(2, 64, 30))
    trainer.train_step(trainer.prepare_batch(batch), trainer.generator)
    trainer.close()
    return trainer, batch


def test_training_walk_matches_the_calls(recorded, tmp_path):
    # TrainerConfig()'s precision, f32 throughout: every call an f32 case
    # (phase kernels' "train-f32" path)
    recorded.mark_f32 = True
    trainer, batch = _training_step(tmp_path)
    want = cs.training_calls(trainer.models.unet_cfg, trainer.models.vae_cfg,
                             trainer.models.clip_cfg, TOK_LEN, batch, 30, 10,
                             f32=True)
    assert all(cs.is_f32(args) for _, args in want)
    flash = [args for kid, args in want if kid == "K1"]
    # the VAE encoder's site, and the 32^2 sites with and without the lse
    assert any(a[3] == 1 for a in flash)
    assert any(cs.has_lse(a) for a in flash) and not all(cs.has_lse(a) for a in flash)
    # one step: the walk gives every call, as many times as it is made
    assert collections.Counter(recorded) == collections.Counter(want)
    cases = cs.kernel_cases({"train-f32": want})
    assert {cs.row_kid(kid, args) for kid, _, args, _ in cases} == {
        "K1/f32", "K2/f32", "K3/f32", "K5a/f32", "K5b/f32"}


def test_mixed_precision_training_walk_matches_the_calls(recorded, tmp_path):
    # mixed precision: the UNet in bf16, prepare_batch's VAE and CLIP in
    # f32 as the JAX trainer encodes (phase kernels' "train" path)
    recorded.mark_f32 = True
    trainer, batch = _training_step(tmp_path, mixed_precision=True)
    want = cs.training_calls(trainer.models.unet_cfg, trainer.models.vae_cfg,
                             trainer.models.clip_cfg, TOK_LEN, batch, 30, 10)
    assert collections.Counter(recorded) == collections.Counter(want)
    n_encoder = len(cs.vae_encoder_calls(trainer.models.vae_cfg, 2, 64))
    assert all(cs.is_f32(args) for _, args in want[:n_encoder])
    assert ("K1", (2, 1024, 1024, 1, 64, "f32")) in want  # the VAE mid block
    flash_unet = [args for kid, args in want[n_encoder:] if kid == "K1"]
    assert flash_unet and not any(cs.is_f32(a) for a in flash_unet)


# route -> (its switches, the feed-forward kernels its eligible sites take)
ROUTES = {
    "default": (cs.DEFAULT, {"K4"}),
    "int8": (cs.INT8, {"K7"}),
    "int8-dequant": (cs.INT8_DEQUANT, set()),
    "split": (cs.SPLIT, {"K6", "K8a", "K8b"}),
    "no-fused-ffn": (cs.Route(pallas_ffn=False, pallas_matmul=True),
                     {"K8a", "K8b"}),
    "int8-matmul": (cs.Route(int8=True, pallas_matmul=True), {"K8a", "K8b"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_unet_walk_matches_the_calls_on_each_route(recorded, route):
    r, ff_kernels = ROUTES[route]
    models = _models(channels=128, channel_mult=(1, 1))
    params = models.unet_params
    if r.int8:
        params = quantize_params(params, min_size=128)
    cfg, b = models.unet_cfg, 1
    g = torch.Generator().manual_seed(1)
    boxes = torch.zeros(b, 30, 4)
    boxes[:, 0] = torch.tensor([0.1, 0.2, 0.5, 0.9])
    masks = torch.zeros(b, 30)
    masks[:, 0] = 1
    with cs.route_env(r), torch.no_grad():
        unet_apply(params, cfg, torch.randn(b, 4, 32, 32, generator=g),
                   torch.tensor([900]),
                   torch.randn(b, TOK_LEN, 32, generator=g), boxes, masks,
                   torch.randn(b, 30, 32, generator=g),
                   torch.randn(b, 5, 32, generator=g), fuser_scale=0.5)
    want = cs.unet_calls(cfg, b, 30, 5, TOK_LEN, route=r)
    assert {kid for kid, _ in want} - {"K1", "K2", "K3"} == ff_kernels
    assert collections.Counter(recorded) == collections.Counter(want)


@pytest.mark.parametrize("args", [(8, 4096, 4096, 8, 40), (8, 1054, 1054, 8, 80),
                                  (2, 70, 33, 3, 40)])
def test_k5_pair_bound_counts_the_function_once(monkeypatch, args):
    """The K5 pair row is held to SDPA's whole backward, so its bound is
    that function's: five N x M x d products and B*H*N*M exponentials, each
    counted once, every operand read and every gradient written once. The
    sum of K5a's and K5b's own bounds counts S, dP and the inputs twice."""
    b, n, m, h, d = args
    clock = 1.98e9
    rows = {}
    for kid in ("K5a", "K5b"):
        rows[kid] = {"shape": "s", "paths": ["train"], "ok": True, "ms": 2.0,
                     "device_ms": 1.5, "library_ms": 1.0 + (kid == "K5b"),
                     "library_device_ms": 1.0,
                     "exp_ms": cs.exp_ms(float(b) * h * n * m, clock)}
    emitted = []
    monkeypatch.setattr(cs, "emit", emitted.append)
    pair = {key: 0.0 for key in cs.PAIR_SUMS}
    pair["shapes"], pair["max_vs_library"] = 0, 0.0
    cs.pair_record(rows["K5a"], rows["K5b"], args, clock, pair)
    (rec,) = emitted
    flops = 10.0 * b * h * n * m * d
    nbytes = 2.0 * (3 * b * n * h * d + 4 * b * m * h * d) + 8.0 * b * h * n
    assert rec["bound_ms"] == pytest.approx(max(
        flops / cs.H100_BF16_FLOPS, nbytes / cs.H100_HBM_BYTES) * 1e3)
    # K5a's S, dP, dQ plus K5b's S, dP, dV, dK: 14 products where 10 are owed
    assert rec["bound_ms"] < cs.bound(14.0 * b * h * n * m * d, 2 * nbytes)[0]
    assert rec["exp_ms"] == rows["K5a"]["exp_ms"]
    assert rec["ms"] == 4.0 and rec["library_ms"] == 1.5
    assert rec["vs_library"] == pytest.approx(4.0 / 1.5)
    assert pair["bound_ms"] == rec["bound_ms"] and pair["shapes"] == 1



CSRC = Path(__file__).resolve().parents[1] / "layoutllm_t2i_torch" / "csrc"
KERNEL_DECL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def _source_kernels():
    """{kernel name: library} of every __global__ function under csrc/."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name in KERNEL_DECL.findall(path.read_text()):
            found[name] = path.stem
    return found


def _group_of(kernel):
    """The PROFILE_GROUPS entry that a profiler row of ``kernel`` lands in
    (first match wins), for the name as torch.profiler shows a template
    instantiation of it."""
    shown = (f"void (anonymous namespace)::{kernel}<gemm_tiles::Cfg<128, 2> >"
             "(CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)").lower()
    return next((g for g, keys in cs.PROFILE_GROUPS
                 if any(k in shown for k in keys)), "other")


def test_profile_groups_and_wgmma_kernels_name_the_sources():
    """chip_smoke's kernel-name lists against the kernels in csrc/: every
    kernel's profile time counts under its own kernel id (not "matmul",
    whose keys "gemm" and "sm90_" a template name can contain), and phase
    build looks for HGMMA in every wgmma kernel of K1, K5a, K5b, K4, K6,
    K7, K8a and K8b and in every kernel of the f32 forms on TF32 wgmma
    (K1/f32, K5a/f32, K5b/f32, K4/f32, K6/f32, K7/f32, K8a/f32, K8b/f32)
    but their pre-passes; no `__global__` of the retired WMMA kernels or of
    the retired mma.sync kernels of K1/f32 (d 40, 80), K5a/f32, K5b/f32,
    K4/f32, K7/f32 and K8b/f32 is left, and no kernel source uses WMMA or
    mma.sync."""
    kernels = _source_kernels()
    lib_of = {kid: Path(meta[1]).stem for kid, meta in cs.KERNEL_META.items()}
    groups = {name.split()[0]: keys for name, keys in cs.PROFILE_GROUPS}
    for kid in cs.KERNEL_META:
        assert groups[kid], kid
        for key in groups[kid]:
            # an f32 instantiation of a template ("gn_cluster_kernel<float>")
            # is named by its kernel
            assert kernels.get(key.split("<")[0]) == lib_of[kid], (kid, key)
    for kernel, lib in kernels.items():
        kid = _group_of(kernel).split()[0]
        assert kid in cs.KERNEL_META and lib_of[kid] == lib, (kernel, kid)
    for lib, names in cs.WGMMA_KERNELS.items():
        for name in names:
            assert kernels.get(name) == lib, name
    retired = {"ffn_res_up_kernel", "ffn_res_down_kernel", "geglu_fused_kernel",
               "ffn_q_up_kernel", "ffn_q_down_kernel", "ffn_up_f32_kernel",
               "ffn_down_f32_kernel", "flash_fwd_f32_kernel", "geglu_f32_kernel",
               "flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel",
               "flash_kv_split_f32_kernel", "ffn_q_up_f32_kernel",
               "ffn_q_down_f32_kernel"}
    assert not retired & set(kernels), retired & set(kernels)
    assert not (CSRC / "ffn_tiles.cuh").exists()
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        assert "wmma::" not in text and "<mma.h>" not in text, path
        assert "mma.sync.aligned" not in text, path
    # the only kernels of those ids without a product: K4's and K7's LN
    # pre-passes
    pre_pass = {"K4": {"ffn_norm_rows_kernel"}, "K7": {"ffn_q_norm_rows_kernel"}}
    for kid in cs.WGMMA_KIDS:
        off_wgmma = set(groups[kid]) - set(cs.WGMMA_KERNELS[lib_of[kid]])
        assert off_wgmma == pre_pass.get(kid, set())
    # the f32 forms on TF32 wgmma: every kernel of their groups but the
    # flash split pre-pass (K1/f32's instantiations, and K5a/f32's, whose
    # call runs the backward's) and K4/f32's LN pre-pass (K7/f32's too,
    # counted under K4/f32)
    widths = (40, 64, 80, 128, 160, 256, 320)
    f32_pre = {"K1/f32": {"flash_split_f32_kernel", "flash_split_cols_f32_kernel"},
               "K5a/f32": {f"flash_split_f32_kernel<{d}, 4>" for d in widths}
               | {"flash_split_cols_f32_kernel<4>"},
               "K4/f32": {"ffn_norm_rows_f32_kernel"}}
    for d in widths:
        for jobs, kid in ((2, "K1/f32"), (4, "K5a/f32")):
            shown = (f"void (anonymous namespace)::flash_split_f32_kernel<{d}, "
                     f"{jobs}>((anonymous namespace)::SplitJobs<{jobs}>, int)")
            assert next(g for g, keys in cs.PROFILE_GROUPS
                        if any(k in shown.lower() for k in keys)).split()[0] == kid
    # the column-tiled pre-pass: K1/f32's past 512 (2 jobs), K5's past 320 (4)
    for jobs, kid in ((2, "K1/f32"), (4, "K5a/f32")):
        shown = (f"void (anonymous namespace)::flash_split_cols_f32_kernel<{jobs}>("
                 f"(anonymous namespace)::SplitJobs<{jobs}>, int, int, int)")
        assert next(g for g, keys in cs.PROFILE_GROUPS
                    if any(k in shown.lower() for k in keys)).split()[0] == kid
    for kid in ("K1/f32", "K5a/f32", "K5b/f32", "K4/f32", "K6/f32", "K7/f32",
                "K8a/f32", "K8b/f32"):
        off_wgmma = set(groups[kid]) - set(cs.WGMMA_KERNELS[lib_of[kid]])
        assert off_wgmma == f32_pre.get(kid, set()), (kid, off_wgmma)


def test_gemm_tiles_sweep_patches_the_sources(tmp_path):
    """The tile sweep (cli/gemm_tiles_sweep.py) builds its variants by
    patching copies of csrc/: the lines it patches must still be there."""
    from layoutllm_t2i_torch.cli.gemm_tiles_sweep import variant_sources

    variant_sources(CSRC, tmp_path / "v", 64, True)
    assert "using UpCfg = gemm_tiles::Cfg<64, 2>;" in (tmp_path / "v" / "ffn.cu").read_text()
    tiles = (tmp_path / "v" / "gemm_tiles.cuh").read_text()
    assert "int narrow) {\n  return true;\n" in tiles


# the f32 phases' walks (generate-f32, int8-f32, routes-f32) on the
# 128-channel model, whose 32^2 feed-forward sites are eligible


@pytest.mark.parametrize("route", ["default", "int8", "split"])
def test_f32_unet_walk_matches_the_calls_on_each_route(recorded, route):
    """An f32 UNet forward: every call an f32 case, K7's site asked with
    the f32 item size, as ops/nn.py asks it."""
    r, ff_kernels = ROUTES[route]
    recorded.mark_f32 = True
    models = _models(channels=128, channel_mult=(1, 1))
    params = models.unet_params
    if r.int8:
        params = quantize_params(params, min_size=128)
    cfg, b = models.unet_cfg, 1
    g = torch.Generator().manual_seed(1)
    boxes = torch.zeros(b, 30, 4)
    boxes[:, 0] = torch.tensor([0.1, 0.2, 0.5, 0.9])
    masks = torch.zeros(b, 30)
    masks[:, 0] = 1
    with cs.route_env(r), torch.no_grad():
        unet_apply(params, cfg, torch.randn(b, 4, 32, 32, generator=g),
                   torch.tensor([900]),
                   torch.randn(b, TOK_LEN, 32, generator=g), boxes, masks,
                   torch.randn(b, 30, 32, generator=g),
                   torch.randn(b, 5, 32, generator=g), fuser_scale=0.5)
    want = cs.f32_calls(cs.unet_calls(cfg, b, 30, 5, TOK_LEN, route=r, itemsize=4))
    assert {kid for kid, _ in want} - {"K1", "K2", "K3"} == ff_kernels
    assert collections.Counter(recorded) == collections.Counter(want)


@pytest.mark.parametrize("route", ["default", "int8"])
def test_f32_generation_walk_counts_every_launch(recorded, route):
    """Phases generate-f32 and int8-f32 hold each f32 form's launches to
    the walk's count: every call of the generation, as many times as it is
    made (distinct=False, every UNet evaluation of the step tables)."""
    r, _ = ROUTES[route]
    recorded.mark_f32 = True
    models = _models(channels=128, channel_mult=(1, 1))
    if r.int8:
        models.unet_params = quantize_params(models.unet_params, min_size=128)
    pipe = InferencePipeline(models, steps=3, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=cs.VAE_CHUNK)
    with cs.route_env(r), torch.no_grad():
        pipe.generate(*cs.REQUESTS, seed=0)
    want = cs.generation_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                               TOK_LEN, cs.REQUESTS, cs.VAE_CHUNK, route=r,
                               evals=cs.unet_evaluations(pipe, 2), f32=True,
                               distinct=False)
    assert collections.Counter(recorded) == collections.Counter(want)
    counts = cs.launches_of(want)
    assert all(kid.endswith("/f32") for kid in counts)
    assert counts.get("K7/f32", 0) > 0 if r.int8 else counts["K4/f32"] > 0


def test_split_route_f32_training_walk_matches_the_calls(recorded, tmp_path):
    """Phase routes-f32's training step: f32 throughout, the norm3 sites
    through K3 and K6, the fusers' dense branch through K3, K8b and K8a;
    each call as many times as the walk gives it."""
    recorded.mark_f32 = True
    models = _models(channels=128, channel_mult=(1, 1))
    with cs.route_env(cs.SPLIT):
        trainer, batch = _training_step(tmp_path, models=models)
    want = cs.training_calls(trainer.models.unet_cfg, trainer.models.vae_cfg,
                             trainer.models.clip_cfg, TOK_LEN, batch, 30, 10,
                             f32=True, route=cs.SPLIT)
    assert collections.Counter(recorded) == collections.Counter(want)
    counts = cs.launches_of(want)
    assert {"K6/f32", "K8a/f32", "K8b/f32", "K5a/f32"} <= set(counts)
    assert "K4/f32" not in counts


def test_f32_timing_times_the_walks_shapes():
    """cli/f32_timing.py times K1/f32, K5a/f32, K5b/f32, K4/f32, K6/f32,
    K7/f32, K8a/f32 and K8b/f32 at the shapes that phase `kernels` gives
    them: each one's distinct f32 cases of the full-width walks of
    generate-f32, int8-f32, train-f32 and routes-f32."""
    from layoutllm_t2i_torch.cli import f32_timing
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    tok_len = clip_cfg.max_length
    batch = next(synthetic_layout_batches(cs.TRAIN_BATCH, 512, cs.TRAIN_MAX_BOXES))
    paths = {name: cs.generation_calls(unet_cfg, vae_cfg, clip_cfg, tok_len,
                                       cs.REQUESTS, cs.VAE_CHUNK, route=route,
                                       f32=True)
             for name, route in (("generate-f32", cs.DEFAULT),
                                 ("int8-f32", cs.INT8))}
    for name, route in (("train-f32", cs.DEFAULT), ("routes-f32", cs.SPLIT)):
        paths[name] = cs.training_calls(unet_cfg, vae_cfg, clip_cfg, tok_len, batch,
                                        cs.TRAIN_MAX_BOXES, cs.TRAIN_MAX_RELATIONS,
                                        f32=True, route=route)
    walked = {(kid, args) for kid, _, args, _ in cs.kernel_cases(paths)
              if kid in f32_timing.CASES and cs.is_f32(args)}
    timed = {(kid, shape + ("f32",)) for kid, shapes in f32_timing.CASES.items()
             for shape in shapes}
    assert timed == walked
    assert {kid: len(s) for kid, s in f32_timing.CASES.items()} == {
        "K1": 12, "K5a": 4, "K5b": 4, "K4": 12, "K6": 3, "K7": 6, "K8a": 3,
        "K8b": 3}


# ---------------------------------------------------------------------------
# phases inpaint and modalities: their calls are recorded as they are made
# (chip_smoke.recorded_calls), and phase kernels' second pass takes its
# shapes from those records


@pytest.fixture
def small_flash(monkeypatch):
    """K1's routing thresholds lowered to the small geometry, so that its
    8^2 latents (64 visual tokens) route the fusers' attention to K1: the
    gatedCA runs' cross-attention at M = 196 and 136 included."""
    monkeypatch.setattr(attention_mod, "FLASH_MIN_Q_LEN", 32)
    monkeypatch.setattr(attention_mod, "FLASH_MIN_KV", 16)


def test_chip_recorder_matches_the_test_recorder(recorded, small_flash):
    """chip_smoke's recorder and this module's see the same calls, in
    order, through a map modality's ConvNeXt (K3 at eps 1e-6, in f32) and
    its gatedCA UNet."""
    models = cs.modality_bundle("gatedCA", "canny", True, "cpu")
    pipe = InferencePipeline(models, steps=2, alpha_type=(1.0, 0.0, 0.0))
    recorded.mark_f32 = True
    with cs.recorded_calls() as calls, torch.no_grad():
        cond = cs.modality_cond(pipe, "canny", None, np.random.default_rng(0).random(
            (40, 40, 3)))
        pipe.run_sampler(cond, torch.zeros(2, 8, 8, 4))
    assert calls == list(recorded)
    assert ("K3", (2 * 112 * 112, 96, 1e-6, "f32")) in calls
    assert ("K1", (4, 64, 196, 2, 16, "f32")) in calls


@pytest.fixture
def counted_as_recorded(monkeypatch):
    """path_counts on the CPU: no CUDA launch happens here, so each run
    counts one launch of every kernel, and the plain route none more."""
    monkeypatch.setattr(cs, "path_counts", lambda: {kid: 1 for kid in cs.KERNEL_META})


def test_phase_inpaint_on_the_cpu(monkeypatch, small_flash, counted_as_recorded):
    """Phase inpaint at the small geometry, PLMS-4 for the exact runs (its
    last step at t = 1, as PLMS-50's): the exact and the fast runs (the
    fast one's UNet evaluations the uncached tables'), the kept region
    within its bound and the planted inverted mask outside it, the
    inpaint_mode UNet's run."""
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    monkeypatch.setattr(cs, "STEPS", 4)

    models = random_models(small=True, device="cpu", seed=0)
    cs.set_alphas(models.unet_params, 0.5)
    img = cs.exact_pipeline(models).generate(*cs.REQUESTS, seed=0)
    counts, calls = cs.phase_inpaint(models, img)
    assert counts == {kid: 3 for kid in cs.KERNEL_META}
    assert {kid for kid, _ in calls} == {"K1", "K2", "K3"}


def test_phase_modalities_on_the_cpu(tmp_path, monkeypatch, small_flash,
                                     counted_as_recorded):
    """Phase modalities at the small geometry, 2 PLMS steps a run: every
    run's conditioning and images, K1 at M = 196 and M = 136 in the
    gatedCA runs."""
    monkeypatch.setattr(cs, "MODALITY_RUNS", tuple(
        (name, fuser, modality, 2) for name, fuser, modality, _ in cs.MODALITY_RUNS))
    source = np.random.default_rng(1).random((16, 16, 3))
    counts, calls = cs.phase_modalities(str(tmp_path / "m"), source, small=True,
                                        device="cpu")
    assert counts == {kid: len(cs.MODALITY_RUNS) for kid in cs.KERNEL_META}
    ms = {args[2] for kid, args in calls if kid == "K1" and args[1] != args[2]}
    assert {196, 136} <= ms
    # the map runs' ConvNeXt LayerNorms, in f32 at eps 1e-6
    assert {args[1] for kid, args in calls if kid == "K3" and 1e-6 in args} == {
        96, 192, 384, 768}


def test_phase_data_on_the_cpu(tmp_path, capsys):
    """Phase data is host-only: here at 16^2 from small source images, the
    fixture, the catalog's three datasets, their concatenation through the
    loader (two epochs, each a permutation), the TSV round trips."""
    rec = cs.phase_data(str(tmp_path / "d"), size=16,
                        sizes=((40, 30), (30, 40), (33, 50), (20, 13),
                               (16, 16), (70, 30)))
    assert rec["ok"] and rec["epochs_permutation"] == [True, True]
    assert rec["lengths"] == [6, 5, 6] and rec["concat_len"] == 23
    assert rec["items_drawn"] == 2 * 23
    assert not (tmp_path / "d").exists()
    assert '"phase": "data"' in capsys.readouterr().out


# phase train-coco's fixture at small sizes: four captioned images and the
# captionless one (landscape first, so the crop drops the edge box), batch
# 2: three steps cross the epoch's two batches
COCO_SMALL = ((64, 48), (48, 64), (50, 33), (64, 64))


def test_train_coco_walk_matches_the_calls(recorded, tmp_path):
    """Phase train-coco's host parts: the fixture and the walk rebuilt from
    a fresh loader (coco_walk) against the calls of a trainer that takes
    three mixed-precision steps from the loader the CLI builds; the batch
    checks (the crowd box, the degenerate box and the captionless image
    absent)."""
    from layoutllm_t2i_torch.data.coco import coco_layout_batches

    recorded.mark_f32 = True
    fx = cs.coco_fixture(str(tmp_path), COCO_SMALL)
    models = _models()
    cfg = TrainerConfig(output_root=str(tmp_path / "out"), name="t",
                        batch_size=2, total_iters=cs.COCO_STEPS,
                        warmup_steps=0, max_boxes=30, max_relations=10,
                        mixed_precision=True)
    trainer = DiffusionTrainer(cfg, coco_layout_batches(fx["root"], 2, 64, 30),
                               models=models)
    trainer.train()
    trainer.close()
    walk = cs.coco_walk(fx, models.unet_cfg, models.vae_cfg, models.clip_cfg,
                        TOK_LEN, 2, 64)
    assert collections.Counter(recorded) == collections.Counter(walk["calls"])
    assert ("K1", (2, 1024, 1024, 1, 64, "f32")) in walk["calls"]  # VAE mid
    checks = cs.coco_batch_checks(walk, fx, 2, 64)
    assert all(checks.values()), checks
    assert len(walk["dataset"]) == len(COCO_SMALL)
    assert {kid for kid, _ in walk["calls"]} | {"K5a", "K5b"} >= {
        kid.split("/")[0] for kid in cs.COCO_WALKED}


# ---------------------------------------------------------------------------
# phases hires, heads5 and train-hires: the seed-0 weights at another latent
# size (SD-1.4 at 768^2) and head count (num_heads 5)


@pytest.fixture
def counted_from_records(monkeypatch):
    """path_counts on the CPU: the launches of the calls that the last
    recorded_calls block recorded (launches_of), at least one of every
    kernel (the small model's feed-forward sites are below K4's width)."""
    last = []
    real = cs.recorded_calls

    @contextlib.contextmanager
    def recorder():
        with real() as calls:
            last[:] = [calls]
            yield calls

    monkeypatch.setattr(cs, "recorded_calls", recorder)
    monkeypatch.setattr(cs, "path_counts", lambda: {
        kid: max(1, cs.launches_of(last[0] if last else []).get(kid, 0))
        for kid in cs.KERNEL_META})


# the small geometry's counterparts of GEOMETRY, with the head dims K1 takes
# there under small_flash's thresholds: 16^2 latents (the VAE's 32^2
# images; d 32 at the 8^2 level, the VAE's mid block's d 64 over 256
# tokens) and 4 heads (d 8 at the 8^2 level; the 4^2 level stays plain);
# channel_mult (1, 2, 4, 8) at 16^2 latents (its own weights; d 16 and 32
# at the 16^2 and 8^2 levels, the middle block at 2^2 and 256 channels)
SMALL_GEOMETRY = {"hires": (dict(image_size=16), (32, 64)),
                  "heads5": (dict(num_heads=4), (8,)),
                  "heads1": (dict(num_heads=1), (32,)),
                  "hires1": (dict(image_size=16, num_heads=1), (32, 64)),
                  "mult8": (dict(image_size=16, channel_mult=(1, 2, 4, 8)),
                            (16, 32))}


@pytest.mark.parametrize("name", sorted(SMALL_GEOMETRY))
def test_phase_geometry_on_the_cpu(monkeypatch, small_flash, counted_from_records,
                                   name):
    """Phase hires, heads5, heads1, hires1 or mult8 at the small geometry, 2
    PLMS steps in f32: the images through both routes, K1's launches the
    walk's site by site at the geometry's head dims; for mult8, with the
    one-warp width lowered to 128 so that the middle block's 256 channels
    stand for C 2560, K3's calls past it the walk's site by site, counted
    in the phase's launches."""
    update, dims = SMALL_GEOMETRY[name]
    monkeypatch.setitem(cs.GEOMETRY, name, update)
    monkeypatch.setitem(cs.GEOMETRY_RUNS, name, ((torch.float32, 2),))
    monkeypatch.setitem(cs.GEOMETRY_DIMS, name, dims)
    if name == "mult8":
        monkeypatch.setattr(LN, "WARP_MAX_C", 128)
    counts, calls = cs.phase_geometry(name, small=True, device="cpu")
    wide = cs.wide_k3_sites(calls)
    if name == "mult8":
        # the middle block's LayerNorms over 3 UNet evaluations at CFG
        # batch 4 (PLMS-2, the gated fusers elided at alpha 0.3 of 2
        # steps): norm1, the relation fuser's first, attn2's and norm3 at 4
        # positions a row, the relation fuser's other two at its 30 boxes
        assert wide == {(16, 256): 12, (120, 256): 6}
        assert counts["K3/f32 past 2048"] == 18 and counts["K3 past 2048"] == 0
    else:
        assert wide == {} and counts["K3/f32 past 2048"] == 0
    flash = [args for kid, args in calls if kid == "K1"]
    assert {args[4] for args in flash} >= set(dims)
    assert counts["K1/f32"] == len(flash)
    # the VAE decoder's last GroupNorm at the images' side (2x the latents')
    side = 2 * update.get("image_size", 8)
    assert calls[-1] == ("K2", (2, side * side, 32, 1e-6, True, "f32"))


def _attention_sites(cfg, b, n_obj, n_rel, ctx_len):
    """Every attention of one UNet forward at batch b as (N, M, d, masked):
    per transformer block the self-attention, the gated fuser's over the
    visual and grounding tokens, the relation fuser's (masked: the JAX
    package passes its relation mask) and the text cross-attention."""
    from layoutllm_t2i_torch.models.unet import input_block_specs, output_block_specs

    lat = cfg.image_size
    levels = [(lat // ds) ** 2 for kind, _, _, ds in input_block_specs(cfg)
              if kind == "res_st"]
    levels.append((lat // 2 ** (len(cfg.channel_mult) - 1)) ** 2)
    levels += [(lat // spec[-1]) ** 2 for spec in output_block_specs(cfg)
               if spec[0] == "res_st"]
    sites = []
    for hw in levels:
        c = cfg.model_channels * cfg.channel_mult[
            {(lat // 2 ** i) ** 2: i for i in range(len(cfg.channel_mult))}[hw]]
        d = c // cfg.num_heads
        sites += [(hw, hw, d, False), (hw + n_obj, hw + n_obj, d, False),
                  (n_obj, n_rel, d, True), (hw, ctx_len, d, False)]
    return [site for site in sites for _ in range(b)][::b]


@pytest.mark.parametrize("name", sorted(cs.GEOMETRY))
def test_geometry_walks_route_as_the_jax_package(name):
    """The full-width walk at each new geometry routes to K1 exactly the
    sites the JAX package sends to its Pallas flash kernel
    (layoutllm_t2i_tpu/ops/attention.py: no mask, N >= _FLASH_MIN_Q_LEN,
    M >= _FLASH_MIN_KV), at the head dims these configurations reach:
    d 40, 80 and 160 at 96^2 latents, 64 and 128 with num_heads 5, 160 and
    320 with num_heads 2, 64, 128 and 256 with num_heads 5 at 96^2, 320
    and 640 with num_heads 1, 320, 640 and 1280 with num_heads 1 at 96^2,
    SD-1.4's 40 and 80 with channel_mult (1, 2, 4, 8) (its 16^2 and 8^2
    levels stay plain); and the training walk at the batch's latents takes
    K5 at every one of them (the lse sites), past 320 (num_heads 1) on K5's
    column-group kernels."""
    from layoutllm_t2i_tpu.ops import attention as jax_attention

    from layoutllm_t2i_torch.models.unet import UNetConfig

    cfg = dataclasses.replace(UNetConfig(), **cs.GEOMETRY[name])
    walk = cs.unet_calls(cfg, 4, 30, 5, 77)
    got = collections.Counter((a[1], a[2], a[4]) for kid, a in walk if kid == "K1")
    want = collections.Counter(
        (n, m, d) for n, m, d, masked in _attention_sites(cfg, 4, 30, 5, 77)
        if not masked and n >= jax_attention._FLASH_MIN_Q_LEN
        and m >= jax_attention._FLASH_MIN_KV)
    assert got == want
    dims = {"hires": {40, 80, 160}, "heads5": {64, 128}, "heads2": {160, 320},
            "hires5": {64, 128, 256}, "heads1": {320, 640},
            "hires1": {320, 640, 1280}, "mult8": {40, 80}}[name]
    assert {d for _, _, d in got} == dims
    assert set(cs.GEOMETRY_DIMS.get(name, ())) - {512} <= dims
    # the training walk at 768^2 images runs the UNet at 96^2 latents, the
    # VAE encoder's mid block at 96^2 (K1 at d 512 over 9216 tokens); at
    # 512^2 at 64^2
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    side = cs.TRAIN_HIRES_SIDE if cfg.image_size == 96 else 512
    batch = {"caption": ["a dog"], "labels": [["dog"]],
             "image": np.zeros((1, side, side, 3))}
    _, vae_cfg, clip_cfg = model_configs(small=False)
    train = cs.training_calls(cfg, vae_cfg, clip_cfg, 77, batch, 30, 10)
    assert set(cs.GEOMETRY_K5_DIMS[name]) == dims
    k5 = cs.sites_by_dim(train, "K5a", cs.GEOMETRY_K5_DIMS[name])
    assert {d for d, _, _ in k5} == dims
    assert cs.sites_by_dim(cs.unet_calls(cfg, 1, 30, 10, 77, train=True),
                           "K5a", cs.GEOMETRY_K5_DIMS[name]) == k5
    widest = {"hires": (606, 8, 160), "heads5": (1054, 5, 128),
              "heads2": (1054, 2, 320), "hires5": (606, 5, 256),
              "heads1": (1054, 1, 640), "hires1": (606, 1, 1280),
              "mult8": (1054, 8, 80)}[name]
    n, heads, d = widest
    assert ("K1", (1, n, n, heads, d, "lse")) in train
    if side == cs.TRAIN_HIRES_SIDE:
        assert ("K1", (1, 9216, 9216, 1, 512, "f32")) in train


@pytest.mark.parametrize("mixed", [True, False])
@pytest.mark.parametrize("name", ["heads2", "hires5", "heads1", "hires1"])
def test_wide_k5_rows_are_the_gradient_checks_sites(name, mixed):
    """Phase kernels holds K5 at d 256 and 320 (num_heads 2 and 5) and past
    320 (num_heads 1: its sites past 320 alone, d 640 and 1280 on the
    column-group kernels) at the sites that phase train-hires' gradient
    checks run (batch 2, N = M, the gated sites' ragged tails of 30 rows),
    as its walk makes them, in the check's type; and every K5 site of that
    walk past WIDE_K5_GEOMETRIES[name] is among them."""
    from layoutllm_t2i_torch.models.unet import UNetConfig

    sites = cs.wide_k5_sites(UNetConfig(), name, mixed)
    cfg = dataclasses.replace(UNetConfig(), **cs.GEOMETRY[name])
    walk = cs.grad_walk(cfg, mixed)
    wide = [d for d in cs.GEOMETRY_K5_DIMS[name] if d > cs.WIDE_K5_GEOMETRIES[name]]
    assert cs.sites_by_dim(sites, "K5a", wide) == cs.sites_by_dim(walk, "K5a", wide)
    tag = () if mixed else ("f32",)
    heads, sized = {"heads2": (2, [(1024, 320)]), "hires5": (5, [(576, 256)]),
                    "heads1": (1, [(1024, 640)]),
                    "hires1": (1, [(2304, 640), (576, 1280)])}[name]
    assert sorted(d for _, d in sized) == wide
    cases = {(kid, args) for kid, _, args, _ in cs.kernel_cases({"g": sites})}
    assert cases == {(kid, (2, r, r, heads, d) + lse + tag)
                     for n, d in sized for r in (n, n + 30)
                     for kid, lse in (("K1", ("lse",)), ("K5a", ()), ("K5b", ()))}
    assert set(cs.WIDE_K5_GEOMETRIES) == {
        g for g, dims in cs.GEOMETRY_K5_DIMS.items() if max(dims) > 160}
    assert set(cs.TRAIN_GRAD_GEOMETRIES) == set(cs.GEOMETRY_K5_DIMS)


def test_ckpt_run_walk_at_one_head_matches_the_calls(recorded, tmp_path):
    """Phase train-hires' --ckpt_path run at num_heads 1 (train-ckpt-heads1)
    is held to training_calls at its config: a mixed-precision step of a
    small trainer at one head records the walk's calls, K5 at every lse
    site of the one head's d (32 and 64 here: the head takes the level's
    channels whole)."""
    recorded.mark_f32 = True
    models = _models()
    models = dataclasses.replace(models, unet_cfg=dataclasses.replace(
        models.unet_cfg, num_heads=1))
    cfg = TrainerConfig(output_root=str(tmp_path), name="t", batch_size=2,
                        total_iters=1, warmup_steps=0, max_boxes=30,
                        max_relations=10, mixed_precision=True)
    trainer = DiffusionTrainer(cfg, iter(()), models=models)
    batch = next(synthetic_layout_batches(2, 96, 30))
    trainer.train_step(trainer.prepare_batch(batch), trainer.generator)
    trainer.close()
    want = cs.training_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                             TOK_LEN, batch, 30, 10)
    assert collections.Counter(recorded) == collections.Counter(want)
    assert "heads1" in cs.TRAIN_CKPT_GEOMETRIES
    lse_sites = {(args[3], args[4]) for kid, args in want
                 if kid == "K1" and cs.has_lse(args)}
    assert lse_sites == {(1, 32), (1, 64)}


def test_training_walk_takes_the_latent_size_of_the_batch(recorded, tmp_path):
    """A training step on images twice the size the UNet config names
    (its image_size only sizes sampling): the walk follows the VAE's
    latents, as the JAX trainer's --image_size does."""
    recorded.mark_f32 = True
    models = _models()
    cfg = TrainerConfig(output_root=str(tmp_path), name="t", batch_size=2,
                        total_iters=1, warmup_steps=0, max_boxes=30,
                        max_relations=10, mixed_precision=True)
    trainer = DiffusionTrainer(cfg, iter(()), models=models)
    batch = next(synthetic_layout_batches(2, 96, 30))
    trainer.train_step(trainer.prepare_batch(batch), trainer.generator)
    trainer.close()
    want = cs.training_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                             TOK_LEN, batch, 30, 10)
    assert collections.Counter(recorded) == collections.Counter(want)
    assert ("K1", (2, 2304, 2304, 2, 16)) in want   # 48^2 latents, not 32^2


def test_generation_walk_at_another_geometry_matches_the_calls(recorded):
    """generation_calls at a latent size and head count other than the
    config's defaults: 48^2 latents (its second level's 576 tokens route
    as SD-1.4's 24^2 sites at 768^2) and 4 heads."""
    models = _models()
    models = dataclasses.replace(models, unet_cfg=dataclasses.replace(
        models.unet_cfg, image_size=48, num_heads=4))
    pipe = InferencePipeline(models, steps=2, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=1)
    with torch.no_grad():
        pipe.generate(["a dog", "a cat"], [([[0.1, 0.1, 0.5, 0.5]], ["a dog"])] * 2,
                      [["dog"], []], seed=0)
    want = cs.generation_calls(models.unet_cfg, models.vae_cfg, models.clip_cfg,
                               TOK_LEN, (["a dog", "a cat"],
                                         [([[0.1, 0.1, 0.5, 0.5]], ["a dog"])] * 2,
                                         [["dog"], []]),
                               1, evals=cs.unet_evaluations(pipe, 2), distinct=False)
    assert collections.Counter(recorded) == collections.Counter(want)
    assert ("K1", (4, 576, 576, 4, 16)) in want and ("K1", (4, 2304, 2304, 4, 8)) in want


# ---------------------------------------------------------------------------
# phase mult8: channel_mult (1, 2, 4, 8), whose deepest level and middle
# block run at 2560 channels: K3 past C 2048 (the block-a-row kernel)


def _mult8_walks():
    """{name: calls} of the full-width channel_mult (1, 2, 4, 8) walks that
    phases mult8, train-grad-mult8 and train-ckpt-mult8 and phase kernels
    hold: the 2-request generation (CFG batch 4), the bench's (CFG batch
    16), a batch-8 training step and the gradient checks' batch 2."""
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    cfg = dataclasses.replace(unet_cfg, **cs.GEOMETRY["mult8"])
    batch = next(synthetic_layout_batches(cs.TRAIN_BATCH, 512, cs.TRAIN_MAX_BOXES))
    return cfg, {
        "generate": cs.generation_calls(cfg, vae_cfg, clip_cfg, 77, cs.REQUESTS,
                                        cs.VAE_CHUNK),
        "bench": cs.generation_calls(cfg, vae_cfg, clip_cfg, 77,
                                     cs.bench_requests(), cs.VAE_CHUNK),
        "train": cs.training_calls(cfg, vae_cfg, clip_cfg, 77, batch,
                                   cs.TRAIN_MAX_BOXES, cs.TRAIN_MAX_RELATIONS),
        "grad": cs.grad_walk(cfg)}


def test_mult8_walks_k3_sites_route_as_the_jax_package():
    """The full-width channel_mult (1, 2, 4, 8) walks' K3 calls past C 2048
    are the middle block's LayerNorms at C 2560 over B x 64 (norm1, the
    relation fuser's first, attn2's, and below K4's 1024 rows norm3 and
    the gated fuser's FF's), B x 94 (the gated fuser's) and B x 30 rows (the relation
    fuser's other two). The JAX package sends a LayerNorm to its Pallas
    kernel where C % 128 == 0 and rows % 8 == 0 (layoutllm_t2i_tpu/ops/
    pallas/norms.py layer_norm_fused): every such site of the generation,
    the bench and the batch-8 step; at the gradient checks' batch 2, 188
    and 60 rows go to its XLA reference instead, the same function, which
    the port runs on K3 as every other LayerNorm."""
    cfg, walks = _mult8_walks()
    assert cfg.model_channels * cfg.channel_mult[-1] == 2560
    want = {"generate": {(256, 2560): 5, (376, 2560): 1, (120, 2560): 2},
            # at 1024 rows both FF sites take K4, its LN inside
            "bench": {(1024, 2560): 3, (1504, 2560): 1, (480, 2560): 2},
            "train": {(512, 2560): 5, (752, 2560): 1, (240, 2560): 2},
            "grad": {(128, 2560): 5, (188, 2560): 1, (60, 2560): 2}}
    for name, calls in walks.items():
        sites = cs.wide_k3_sites(calls)
        assert sites == want[name], name
        jax_routed = {rc for rc in sites if rc[1] % 128 == 0 and rc[0] % 8 == 0}
        assert jax_routed == (set(sites) - {(188, 2560), (60, 2560)}), name
    # the f32 walk holds the same sites as f32 calls
    assert cs.wide_k3_sites(cs.f32_calls(walks["train"])) == want["train"]


def test_kernel_rows_past_2048_are_the_walks_and_the_edges():
    """Phase kernels' new rows: K3 past C 2048 at the mult8 walks' sites and
    K3_WIDE_CALLS' edges (C 2056, 2560 at 257 rows, 5120, 16384), both
    types; K2 at C 3840 and 5120 over 8^2 positions on the cluster path
    (slabs 120 and 160, bf16 and f32 tiles); MULT8_BENCH_FF_CALLS the
    FF sites of the bench's CFG batch 16 at the middle block (M 1024, K
    2560: K4 on the default route, K7 on the int8 one)."""
    cfg, walks = _mult8_walks()
    paths = {"k3-wide": cs.K3_WIDE_CALLS, "mult8": walks["generate"],
             "mult8-f32": cs.f32_calls(walks["generate"]),
             "train-mult8": walks["train"],
             "train-mult8-f32": cs.f32_calls(walks["train"]),
             "mult8-bench-ff": cs.MULT8_BENCH_FF_CALLS}
    cases = {(kid, args) for kid, _, args, _ in cs.kernel_cases(paths)}
    k3 = {args for kid, args in cases if kid == "K3" and args[1] > 2048}
    edges = {(8, 2056), (257, 2560), (512, 5120), (64, 16384)}
    walked = {(256, 2560), (376, 2560), (120, 2560), (512, 2560), (752, 2560),
              (240, 2560)}
    assert k3 == {shape + tag for shape in edges | walked
                  for tag in ((), ("f32",))}
    assert {LN.entry_point(c, dt) for _, c, *_ in k3 for dt in (
        torch.bfloat16, torch.float32)} == {"llt2i_layer_norm_wide",
                                            "llt2i_layer_norm_wide_f32"}
    k2 = {(args[0], args[2]) + args[5:] for kid, args in cases
          if kid == "K2" and args[1] == 64 and args[2] in (3840, 5120)}
    assert k2 == {(n, c) + tag for n in (4, 8) for c in (3840, 5120)
                  for tag in ((), ("f32",))}
    for n, c, *tag in k2:
        plan = cs.gn_plan(n, 64, c, itemsize=4 if tag else 2)
        assert (plan.path, plan.slab) == ("cluster", c // 32)
    bench = cs.unet_calls(cfg, 16, 30, 5, 77)
    bench_int8 = cs.unet_calls(cfg, 16, 30, 5, 77, route=cs.INT8)
    ff = {(kid, args) for kid, args in bench + bench_int8
          if kid in ("K4", "K7") and args[1] == 2560}
    assert ff == {("K4", (1024, 2560, s)) for s in (1.0, 0.5)} | {
        ("K7", (1024, 2560, s)) for s in (1.0, 0.5)}
    rows = set(cs.MULT8_BENCH_FF_CALLS)
    assert {c for c in rows if not cs.is_f32(c[1])} <= ff
    assert ("K4", (1024, 2560, 1.0, "f32")) in rows
