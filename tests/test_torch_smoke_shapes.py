"""chip_smoke.py checks every kernel at the shapes that its main paths give
it, walked from the model configs. These tests hold that walk against the
kernel calls that a small model really makes on the CPU: one generation
and one training step, with every wrapper call recorded as chip_smoke
describes it. The geometry is small but routes sites to K1 (32^2 latents:
1024 visual tokens and 1054 with the grounding tokens; the VAE mid block at
32^2) and leaves others on the plain path (16^2), as the full model does.
"""
import collections
import importlib.util
import os

import pytest
import torch

from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
from layoutllm_t2i_torch.kernels.dispatch import needs_grad
from layoutllm_t2i_torch.models.clip_text import CLIPTextConfig, init_clip_text_params
from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
from layoutllm_t2i_torch.models.initializers import Init
from layoutllm_t2i_torch.models.unet import UNetConfig, init_unet_params
from layoutllm_t2i_torch.models.vae import VAEConfig, init_vae_params
from layoutllm_t2i_torch.ops import attention as attention_mod
from layoutllm_t2i_torch.ops import nn as nn_mod
from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule
from layoutllm_t2i_torch.pipeline.inference import GligenModels, InferencePipeline
from layoutllm_t2i_torch.training.diffusion_trainer import DiffusionTrainer, TrainerConfig
from layoutllm_t2i_torch.utils.trees import ParamTree


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()
TOK_LEN = 8


def _models():
    gen = torch.Generator().manual_seed(0)
    ini = Init(gen, torch.device("cpu"), torch.float32)
    unet_cfg = UNetConfig(image_size=32, model_channels=32, num_res_blocks=1,
                          attention_resolutions=(2, 1), channel_mult=(1, 2),
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


@pytest.fixture
def recorded(monkeypatch):
    """Every kernel wrapper call, as (kid, args) in chip_smoke's terms."""
    calls = []
    gn, ln = nn_mod._group_norm_rows, nn_mod._layer_norm_rows
    ff, fa = nn_mod.ffn_ln_geglu, attention_mod.flash_attention

    def group_norm(x, w, b, groups, eps, silu):
        calls.append(("K2", (*x.shape, eps, silu)))
        return gn(x, w, b, groups, eps, silu)

    def layer_norm(x, w, b, eps):
        calls.append(("K3", tuple(x.shape)))
        return ln(x, w, b, eps)

    def ffn(x, lw, lb, w1, b1, w2, b2, s):
        is_one = isinstance(s, float) and s == 1.0
        calls.append(("K4", (*x.shape, 1.0 if is_one else 0.5)))
        return ff(x, lw, lb, w1, b1, w2, b2, s)

    def flash(q, k, v, heads, scale):
        b, n, hc = q.shape
        args = (b, n, k.shape[1], heads, hc // heads)
        calls.append(("K1", args + (("lse",) if needs_grad(q, k, v) else ())))
        return fa(q, k, v, heads, scale)

    monkeypatch.setattr(nn_mod, "_group_norm_rows", group_norm)
    monkeypatch.setattr(nn_mod, "_layer_norm_rows", layer_norm)
    monkeypatch.setattr(nn_mod, "ffn_ln_geglu", ffn)
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
    assert any(kid == "K1" for kid, _ in want)
    # PLMS runs the UNet several times, with and without the gated fusers:
    # the walk covers each distinct call
    assert set(recorded) == set(want)


def test_training_walk_matches_the_calls(recorded, tmp_path):
    cfg = TrainerConfig(output_root=str(tmp_path), name="t", batch_size=2,
                        total_iters=1, warmup_steps=0, max_boxes=30,
                        max_relations=10)
    trainer = DiffusionTrainer(cfg, iter(()), models=_models())
    batch = next(synthetic_layout_batches(2, 64, 30))
    trainer.train_step(trainer.prepare_batch(batch), trainer.generator)
    trainer.close()
    want = cs.training_calls(trainer.models.unet_cfg, trainer.models.vae_cfg,
                             trainer.models.clip_cfg, TOK_LEN, batch, 30, 10)
    flash = [args for kid, args in want if kid == "K1"]
    # the VAE encoder's site, and the 32^2 sites with and without the lse
    assert any(a[3] == 1 for a in flash)
    assert any(len(a) > 5 for a in flash) and any(len(a) == 5 for a in flash)
    # one step: the walk gives every call, as many times as it is made
    assert collections.Counter(recorded) == collections.Counter(want)
    cases = cs.kernel_cases({"train": want})
    assert {kid for kid, *_ in cases} == set(cs.KERNEL_META)
