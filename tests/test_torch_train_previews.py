"""The trainer's sample previews against the JAX trainer's, on the CPU at the
tiny training geometry.

* ``sample_previews`` in f32 on both trainers, the same weights (the JAX
  tree carried over with checkpoint/from_jax.py, alphas 0.5 so the gated
  and relation fusers act), the same host batch and the same noise: the
  port draws its noise from the trainer's generator, and the JAX trainer's
  ``jax.random.normal`` draw is handed that noise. PLMS-4, guidance 5, no
  alpha schedule. The sample grids pass tests/parity_setup.py's gates
  (PSNR >= 35 dB, SSIM >= 0.98); ``samples_<iter>.png`` and
  ``real_<iter>.png`` are written and decode to grids of 16² tiles.
* Mixed precision: the preview pipeline computes in bf16 (the frozen VAE
  decodes from a bf16 copy made once, the text encoder stays the trainer's
  f32 module), one pipeline a run, no UNet tensor changes, and ``check_supported`` accepts previews:
  ``train()`` writes them at its saves; ``cli/train_diffusion.py
  --enable_previews`` too.
"""
import numpy as np
import jax
import pytest
import torch

from layoutllm_t2i_tpu.models.clip_tokenizer import HashTokenizer as JaxHashTokenizer
from layoutllm_t2i_tpu.training import diffusion_trainer as jdt
from layoutllm_t2i_tpu.utils import images as jimages

from parity_setup import PSNR_GATE_DB, SSIM_GATE, psnr, ssim
from test_torch_train import jax_tiny_models, set_alphas

from layoutllm_t2i_torch.checkpoint.from_jax import gligen_models_from_jax
from layoutllm_t2i_torch.cli import train_diffusion as cli
from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
from layoutllm_t2i_torch.training import diffusion_trainer as pdt
from layoutllm_t2i_torch.utils.images import make_grid, read_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PREVIEW = dict(batch_size=2, total_iters=2, save_every_iters=1, log_every=1,
               warmup_steps=1, max_boxes=30, max_relations=5,
               disable_inference_in_training=False, preview_steps=4,
               preview_guidance=5.0, async_ckpt=False)


def _jax_models():
    m = jax_tiny_models()
    set_alphas(m["unet_params"], 0.5)
    return m


def _port_trainer(tmp_path, name, **kw):
    cfg = pdt.TrainerConfig(output_root=str(tmp_path), name=name,
                            **{**PREVIEW, **kw})
    models = gligen_models_from_jax(
        _jax_models(), HashTokenizer(max_length=8, vocab_size=512), device="cpu")
    return pdt.DiffusionTrainer(cfg, synthetic_layout_batches(2, 16, 30),
                                models=models)


def _recorder(module, monkeypatch, attr="save_image_grid"):
    """Record the arrays ``module.save_image_grid`` writes."""
    seen = {}
    real = getattr(module, attr)

    def save(images, path, *args, **kw):
        seen[path.rsplit("/", 1)[-1]] = np.asarray(images)
        return real(images, path, *args, **kw)

    monkeypatch.setattr(module, attr, save)
    return seen


def test_previews_match_jax(tmp_path, monkeypatch):
    host = next(synthetic_layout_batches(2, 16, 30, seed=3))
    tr = _port_trainer(tmp_path / "port", "p")
    cfg_u = tr.models.unet_cfg
    shape = (2, cfg_u.image_size, cfg_u.image_size, cfg_u.in_channels)
    # the noise the port draws next: the trainer's generator, cloned
    gen = torch.Generator().set_state(tr.generator.get_state())
    noise = torch.randn(shape, generator=gen).numpy()

    jm = _jax_models()
    jm["tokenizer"] = JaxHashTokenizer(max_length=8, vocab_size=512)
    jcfg = jdt.TrainerConfig(output_root=str(tmp_path / "jax"), name="j",
                             **PREVIEW)
    jtr = jdt.DiffusionTrainer(jcfg, iter(()), models=jm)
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, s, dtype=None: (
        jax.numpy.asarray(noise) if tuple(s) == shape else normal(key, s, dtype)))
    want = _recorder(jimages, monkeypatch)
    jtr.sample_previews(host, 1)
    jtr.ckpt_writer.wait()

    got = _recorder(pdt, monkeypatch)
    tr.sample_previews(host, 1)
    tr.close()
    assert tr._preview_pipe.models.vae_params is tr.models.vae_params  # f32
    assert set(got) == set(want) == {"samples_00000001.png", "real_00000001.png"}
    assert got["samples_00000001.png"].shape == (2, 16, 16, 3)
    for a, b in zip(got["samples_00000001.png"], want["samples_00000001.png"]):
        assert psnr(a, b) >= PSNR_GATE_DB and ssim(a, b) >= SSIM_GATE
    np.testing.assert_array_equal(got["real_00000001.png"], want["real_00000001.png"])
    for name, imgs in got.items():
        with open(f"{tr.run_dir}/{name}", "rb") as f:
            grid = read_png(f.read())
        assert grid.shape == make_grid(imgs).shape == (16, 34, 3)
    with open(f"{tr.run_dir}/samples_00000001.txt") as f:
        assert f.read().splitlines() == list(host["caption"])


def test_mixed_precision_previews_change_no_weight(tmp_path):
    tr = _port_trainer(tmp_path, "mp", mixed_precision=True, total_iters=3)
    before = {k: v.clone() for k, v in tr.models.unet_params.state_dict().items()}
    frozen_bf16 = tr.train_step._frozen
    tr.sample_previews(next(synthetic_layout_batches(2, 16, 30)), 7)
    pipe = tr._preview_pipe
    assert pipe.models.compute_dtype == torch.bfloat16
    assert (pipe.steps, pipe.sampler, pipe.guidance_scale, pipe.alpha_type) == (
        4, "plms", 5.0, None)
    # the frozen VAE decodes in bf16: a copy made once; the text encoder
    # is the trainer's f32 module
    assert pipe.models.clip_params is tr.models.clip_params
    vae = tr.models.vae_params.state_dict()
    for k, v in pipe.models.vae_params.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, vae[k].to(torch.bfloat16)), k
    after = tr.models.unet_params.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert tr.train_step._frozen is frozen_bf16
    with open(f"{tr.run_dir}/samples_00000007.png", "rb") as f:
        assert read_png(f.read()).shape == (16, 34, 3)
    # train(): a preview at each save (iterations 1 and 2 of 0-2), through
    # the same pipeline
    tr.train()
    tr.close()
    assert tr._preview_pipe is pipe
    for it in (2, 3):
        for kind in ("samples", "real"):
            with open(f"{tr.run_dir}/{kind}_{it:08d}.png", "rb") as f:
                assert read_png(f.read()).shape == (16, 34, 3)


def test_check_supported_accepts_previews_and_cli_writes_them(tmp_path):
    pdt.check_supported(pdt.TrainerConfig(disable_inference_in_training=False))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pdt.check_supported(pdt.TrainerConfig(num_devices=2))
    cli.main(["--small", "--synthetic", "--device", "cpu", "--batch_size", "2",
              "--total_iters", "2", "--save_every_iters", "5",
              "--warmup_steps", "1", "--output_root", str(tmp_path),
              "--name", "cli", "--sync_ckpt", "--enable_previews",
              "--preview_steps", "2"])
    run = tmp_path / "cli" / "tag00"
    for kind in ("samples", "real"):
        assert read_png((run / f"{kind}_00000002.png").read_bytes()).shape == (16, 34, 3)
