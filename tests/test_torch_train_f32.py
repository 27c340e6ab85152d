"""f32 diffusion training, the JAX package's default, against the JAX
trainer on the CPU at small geometry; and the trainer's encoders in f32.

* ``prepare_batch`` (VAE encode, CLIP context, pooled phrase and relation
  embeddings) against the JAX trainer's ``prepare_batch`` / ``_encode_fn``
  on the same numpy images, under ``mixed_precision=True`` and under the
  default: every output f32 and equal to 1e-5. z is compared through the
  posterior mean (``sample=False`` on both sides). The JAX trainer keeps
  its VAE and CLIP in f32 whatever the precision, so the port must too.
* One iteration of ``DiffusionTrainer`` with ``TrainerConfig()``'s
  precision (f32) against the JAX trainer's: the loss of the same batch,
  t, noise and grounding keep to 1e-5 relative, the ``rela_fuse``
  gradients to 1e-4 of the largest (the gate of
  ``tests/test_torch_train.py``), and the AdamW update the trainer makes
  from its gradients against optax's from the same gradients, as
  ``test_three_updates_match_optax`` compares them.
* The CLI without ``--mixed_precision`` (f32) and with it: both export f32
  VAE and CLIP weights in the reference ``.pth``.

Weights come from the JAX initializers through checkpoint/from_jax.py
(``gligen_models_from_jax``, f32 as it is), with the fuser and relation
alphas set to 0.5 so the relation branch carries a gradient.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from layoutllm_t2i_tpu.diffusion import ddpm as jddpm
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.models.clip_tokenizer import HashTokenizer as JaxHashTokenizer
from layoutllm_t2i_tpu.training import diffusion_trainer as jdt
from layoutllm_t2i_tpu.training import train_step as jts

from layoutllm_t2i_torch.checkpoint.from_jax import gligen_models_from_jax, torch_layout
from layoutllm_t2i_torch.cli import train_diffusion as cli
from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.training import diffusion_trainer as pdt
from layoutllm_t2i_torch.training import train_step as pts
from layoutllm_t2i_torch.utils.trees import flatten_tree
from test_torch_train import jax_tiny_models, set_alphas
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BATCH, MAX_BOXES, MAX_RELATIONS = 2, 30, 5


@pytest.fixture
def posterior_mean(monkeypatch):
    """Both trainers' VAE encode returns the posterior mean (no draw)."""
    jax_encode, port_encode = jdt.vae_encode, pdt.vae_encode
    monkeypatch.setattr(jdt, "vae_encode", lambda p, cfg, x, rng=None, sample=True:
                        jax_encode(p, cfg, x, rng=rng, sample=False))
    monkeypatch.setattr(pdt, "vae_encode", lambda p, cfg, x, generator=None, sample=True:
                        port_encode(p, cfg, x, generator=generator, sample=False))


def _models():
    jm = jax_tiny_models()
    jm["unet_params"] = set_alphas(jm["unet_params"], 0.5)
    return jm


def _trainers(tmp_path, jm, **kw):
    cfg = dict(batch_size=BATCH, total_iters=1, warmup_steps=0, log_every=1,
               max_boxes=MAX_BOXES, max_relations=MAX_RELATIONS, **kw)
    jtr = jdt.DiffusionTrainer(
        jdt.TrainerConfig(output_root=str(tmp_path / "jax"), name="t", **cfg),
        iter(()), models={**jm, "tokenizer": JaxHashTokenizer(max_length=8,
                                                             vocab_size=512)})
    ptr = pdt.DiffusionTrainer(
        pdt.TrainerConfig(output_root=str(tmp_path / "port"), name="t", **cfg),
        iter(()), models=gligen_models_from_jax(
            jm, HashTokenizer(max_length=8, vocab_size=512), device="cpu"))
    return jtr, ptr


def _host_batch():
    return next(synthetic_layout_batches(BATCH, 16, MAX_BOXES))


def _compare_batches(jb, pb):
    """The port's prepared batch against the JAX trainer's: f32, 1e-5."""
    for key in ("context", "phrase_embeddings", "relations", "boxes", "masks"):
        assert pb[key].dtype is torch.float32, key
        np.testing.assert_allclose(pb[key].numpy(), np.asarray(jb[key]),
                                   atol=1e-5, err_msg=key)
    assert pb["z"].dtype is torch.float32
    z = pb["z"].permute(0, 2, 3, 1).numpy()   # NCHW -> the JAX NHWC
    np.testing.assert_allclose(z, np.asarray(jb["z"]), atol=1e-5)
    assert float(np.abs(np.asarray(jb["relations"])).max()) > 0


@pytest.mark.parametrize("mixed_precision", [True, False])
def test_prepare_batch_encodes_in_f32_as_the_jax_trainer(tmp_path, posterior_mean,
                                                         mixed_precision):
    jtr, ptr = _trainers(tmp_path, _models(), mixed_precision=mixed_precision)
    batch = _host_batch()
    jb = jtr.prepare_batch(batch, jax.random.PRNGKey(0))
    pb = ptr.prepare_batch(batch)
    _compare_batches(jb, pb)
    # the frozen encoders stay f32 (the .pth exports them so), the UNet's
    # masters are f32, its compute dtype the step's
    m = ptr.models
    assert all(p.dtype is torch.float32 for tree in (m.vae_params, m.clip_params,
                                                      m.unet_params)
               for p in tree.parameters())
    assert ptr.step_cfg.compute_dtype is (torch.bfloat16 if mixed_precision
                                          else torch.float32)
    ptr.close()


def _jax_loss_and_grads(jtr, jb, t, noise, keep):
    """jax.value_and_grad over the JAX trainer's trainable (rela_fuse)
    subtree of the composition its loss_fn runs, with the draws given."""
    cfg = jtr.step_cfg
    train = jax.device_get(jtr.state.params)
    frozen = jax.device_get(jtr.frozen_params)

    def loss(train_):
        p = jts.combine_params(train_, frozen)
        xn = jddpm.q_sample(cfg.schedule, jb["z"], jnp.asarray(t), jnp.asarray(noise))
        eps = junet.unet_apply(p, cfg.unet_cfg, xn, jnp.asarray(t), jb["context"],
                               jb["boxes"] * keep, jb["masks"] * keep,
                               jb["phrase_embeddings"] * keep, jb["relations"])
        return jnp.mean((eps - jnp.asarray(noise)) ** 2)

    value, grads = jax.jit(jax.value_and_grad(loss))(train)
    return float(value), grads, train


def test_f32_trainer_iteration_matches_the_jax_trainer(tmp_path, posterior_mean,
                                                       monkeypatch):
    jtr, ptr = _trainers(tmp_path, _models())
    assert not jtr.config.mixed_precision and not ptr.config.mixed_precision
    assert ptr.step_cfg.compute_dtype is torch.float32
    batch = _host_batch()
    jb = jtr.prepare_batch(batch, jax.random.PRNGKey(0))
    pb = ptr.prepare_batch(batch)
    _compare_batches(jb, pb)

    rng = np.random.default_rng(7)
    t = np.asarray([901, 41])
    noise = rng.standard_normal(np.asarray(jb["z"]).shape).astype(np.float32)
    keep = np.float32(1.0)
    want_loss, want, train0 = _jax_loss_and_grads(jtr, jb, t, noise, keep)
    want = {k: torch_layout(k, np.asarray(v)) for k, v in flatten_tree(want).items()
            if v is not None}

    step = ptr.train_step
    draws = (torch.from_numpy(t), pnn.nhwc_to_nchw(torch.from_numpy(noise)),
             torch.tensor(keep))
    loss, grads = step.grads(pb, *draws)
    assert set(step.params) == set(want) and len(want) > 20
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for name, g in zip(step.params, grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4 * scale,
                                   err_msg=name)

    # the iteration itself: the trainer's step on the same draws, and its
    # AdamW update against optax's from the same gradients
    monkeypatch.setattr(pts, "draw", lambda cfg, gen, z: draws)
    before = {n: p.detach().clone() for n, p in step.params.items()}
    got_loss = step(pb, ptr.generator)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
    tx = jts.make_partitioned_optimizer(jtr.step_cfg)
    params = {n: before[n].numpy() for n in step.params}
    updates, _ = tx.update({n: g.numpy() for n, g in zip(step.params, grads)},
                           tx.init(params), params)
    new = optax.apply_updates(params, updates)
    for name, p in step.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(new[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert any(not torch.equal(p, before[n]) for n, p in step.params.items())
    # in f32 the frozen weights are the masters themselves
    masters = dict(ptr.models.unet_params.named_parameters())
    assert all(t_.data_ptr() == masters[n].data_ptr()
               for n, t_ in step._frozen.items())
    ptr.close()


@pytest.mark.parametrize("extra", [[], ["--mixed_precision"]])
def test_cli_trains_and_exports_f32_encoders(tmp_path, extra):
    """The CLI's small synthetic drive, f32 by default, and with
    --mixed_precision: the exported .pth carries f32 VAE and CLIP weights
    either way, as the JAX exporter's does."""
    argv = ["--small", "--synthetic", "--device", "cpu", "--batch_size", "2",
            "--total_iters", "2", "--save_every_iters", "5", "--warmup_steps",
            "1", "--output_root", str(tmp_path), "--name", "cli",
            "--export_reference_ckpt", "--sync_ckpt", *extra]
    cli.main(argv)
    pth = torch.load(tmp_path / "cli" / "tag00" / "checkpoint_00000002.pth",
                     weights_only=False)
    for module in ("autoencoder", "text_encoder", "model"):
        dtypes = {v.dtype for v in pth[module].values() if v.is_floating_point()}
        assert dtypes == {torch.float32}, (module, dtypes)
    assert not cli.parse_args(argv[:2]).mixed_precision
