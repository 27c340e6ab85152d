"""The training slice against the JAX package, on the CPU at small geometry.

* Loss and gradients: ``loss_from_draws`` and its gradients over the
  ``rela_fuse`` subtree (alphas 0.5, so the relation branch carries a
  gradient) against ``jax.value_and_grad`` of the same composition,
  q_sample -> unet_apply -> f32 MSE, with the same t, noise and grounding
  keep. Tolerance 1e-4 of the largest gradient, as module parity holds.
  ``remat`` gives the same gradients; ``accum_steps`` averages the
  microbatches' gradients into one update.
* Three optimizer updates (AdamW with decoupled decay, and SGD) with
  ``warmup_steps=2`` against optax's ``make_partitioned_optimizer`` fed the
  same gradients; the constant and cosine schedules against optax at
  counts 0-5. f32 on both sides: 1e-6 relative.
* The trainer: three iterations, a save, an auto-resume at iteration >= 2,
  only ``rela_fuse`` tensors changed; the exported reference ``.pth``
  against the JAX exporter's for the same weights; the CLI drive.

Inputs come from a numpy seed and weights from the JAX initializers,
carried over with checkpoint/from_jax.py.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from layoutllm_t2i_tpu.checkpoint.export import export_gligen_checkpoint as jax_export
from layoutllm_t2i_tpu.diffusion import ddpm as jddpm
from layoutllm_t2i_tpu.models import clip_text as jclip
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.models.clip_text import CLIPTextConfig, init_clip_text_params
from layoutllm_t2i_tpu.models.clip_tokenizer import HashTokenizer as JaxHashTokenizer
from layoutllm_t2i_tpu.models.vae import VAEConfig, init_vae_params
from layoutllm_t2i_tpu.ops.schedules import make_ddpm_schedule
from layoutllm_t2i_tpu.training import train_step as jts

from layoutllm_t2i_torch.checkpoint.export import export_gligen_checkpoint
from layoutllm_t2i_torch.checkpoint.from_jax import (
    gligen_models_from_jax, param_tree_from_jax, torch_layout,
)
from layoutllm_t2i_torch.cli import train_diffusion as cli
from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
from layoutllm_t2i_torch.models.clip_text import clip_text_apply
from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
from layoutllm_t2i_torch.models.unet import UNetConfig
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule as port_schedule
from layoutllm_t2i_torch.training import train_step as pts
from layoutllm_t2i_torch.training.diffusion_trainer import (
    DiffusionTrainer, TrainerConfig,
)
from layoutllm_t2i_torch.utils.trees import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL_UNET = dict(image_size=8, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2, 1), channel_mult=(1, 2),
                  num_heads=2)
TINY_UNET = dict(SMALL_UNET, context_dim=32, grounding_in_dim=32,
                 grounding_out_dim=32)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def set_alphas(tree, value):
    for k, v in tree.items():
        if isinstance(v, dict):
            set_alphas(v, value)
        elif k.startswith("alpha_"):
            tree[k] = np.asarray(value, np.float32)
    return tree


def jax_tiny_models(seed=0):
    """tests/test_diffusion_trainer.py's tiny_models geometry."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    unet_cfg = junet.UNetConfig(**TINY_UNET)
    vae_cfg = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    clip_cfg = CLIPTextConfig(num_layers=1, hidden_size=32, num_heads=2,
                              intermediate_size=64, vocab_size=512)
    return dict(unet_cfg=unet_cfg, unet_params=init_unet_params_np(k1, unet_cfg),
                vae_cfg=vae_cfg, vae_params=init_vae_params(k2, vae_cfg),
                clip_cfg=clip_cfg, clip_params=init_clip_text_params(k3, clip_cfg),
                schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012))


def init_unet_params_np(key, cfg):
    return jax.tree.map(np.asarray, junet.init_unet_params(key, cfg))


# ---------------------------------------------------------------------------
# loss and gradients


def test_loss_and_rela_fuse_grads_match_jax(rng):
    cfg_j = junet.UNetConfig(**SMALL_UNET)
    params = set_alphas(init_unet_params_np(jax.random.PRNGKey(5), cfg_j), 0.5)
    sched = make_ddpm_schedule("linear", 1000, 0.00085, 0.012)
    b = 2
    z = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    t = np.asarray([901, 41])
    ctx = rng.standard_normal((b, 77, 768)).astype(np.float32)
    boxes = np.zeros((b, 30, 4), np.float32)
    boxes[:, :2] = [[0.1, 0.2, 0.6, 0.9], [0.5, 0.1, 0.95, 0.6]]
    masks = np.zeros((b, 30), np.float32)
    masks[:, :2] = 1
    pos = rng.standard_normal((b, 30, 768)).astype(np.float32)
    rel = rng.standard_normal((b, 5, 768)).astype(np.float32)
    keep = np.float32(1.0)

    train, frozen = jts.partition_params(params, jts.rela_fuse_only)

    def jloss(train_):
        p = jts.combine_params(train_, frozen)
        xn = jddpm.q_sample(sched, jnp.asarray(z), jnp.asarray(t), jnp.asarray(noise))
        eps = junet.unet_apply(p, cfg_j, xn, jnp.asarray(t), jnp.asarray(ctx),
                               jnp.asarray(boxes) * keep, jnp.asarray(masks) * keep,
                               jnp.asarray(pos) * keep, jnp.asarray(rel))
        return jnp.mean((eps - jnp.asarray(noise)) ** 2)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(train)
    want = {k: torch_layout(k, v) for k, v in flatten_tree(want).items()
            if v is not None}

    cfg_p = pts.TrainStepConfig(unet_cfg=UNetConfig(**SMALL_UNET),
                                schedule=port_schedule("linear", 1000, 0.00085, 0.012))
    step = pts.TrainStep(cfg_p, param_tree_from_jax(params))
    batch = {"z": pnn.nhwc_to_nchw(_t(z)), "context": _t(ctx), "boxes": _t(boxes),
             "masks": _t(masks), "phrase_embeddings": _t(pos), "relations": _t(rel)}
    loss, grads = step.grads(batch, _t(t), pnn.nhwc_to_nchw(_t(noise)),
                             torch.tensor(keep))
    assert set(step.params) == set(want) and len(want) > 20
    assert all("rela_fuse" in name for name in want)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for name, g in zip(step.params, grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4 * scale,
                                   err_msg=name)
    # the gated relation branch really carries a gradient at alpha 0.5
    assert float(np.abs(want["input_blocks.1.1.transformer_blocks.0.rela_fuse."
                             "attn.to_q.weight"]).max()) > 0
    # remat (torch.utils.checkpoint around the UNet) changes nothing
    remat = pts.TrainStep(dataclasses.replace(cfg_p, remat=True), step.unet)
    _, again = remat.grads(batch, _t(t), pnn.nhwc_to_nchw(_t(noise)),
                           torch.tensor(keep))
    for a, b_ in zip(grads, again):
        torch.testing.assert_close(a, b_)


def test_accumulated_step_averages_microbatch_grads(rng):
    """accum_steps = 2: each microbatch draws its own t, noise and keep from
    the generator in turn, the gradients are averaged, one update is made
    (SGD, warmup 0: the update is -lr times the average)."""
    cfg_j = junet.UNetConfig(**SMALL_UNET)
    params = set_alphas(init_unet_params_np(jax.random.PRNGKey(6), cfg_j), 0.5)
    cfg = pts.TrainStepConfig(unet_cfg=UNetConfig(**SMALL_UNET),
                              schedule=port_schedule("linear", 1000, 0.00085, 0.012),
                              optimizer="sgd", learning_rate=0.1, warmup_steps=0,
                              accum_steps=2)
    step = pts.TrainStep(cfg, param_tree_from_jax(params))
    b = 4
    batch = {"z": pnn.nhwc_to_nchw(_t(rng.standard_normal((b, 8, 8, 4)).astype(np.float32))),
             "context": _t(rng.standard_normal((b, 77, 768)).astype(np.float32)),
             "boxes": torch.zeros(b, 30, 4), "masks": torch.zeros(b, 30),
             "phrase_embeddings": torch.zeros(b, 30, 768),
             "relations": _t(rng.standard_normal((b, 5, 768)).astype(np.float32))}
    gen = torch.Generator().manual_seed(3)
    replay = torch.Generator().manual_seed(3)
    before = [p.detach().clone() for p in step.params.values()]
    want_grads, want_loss = None, 0.0
    for i in (0, 1):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        loss, grads = step.grads(mb, *pts.draw(cfg, replay, mb["z"]))
        want_loss += float(loss) / 2
        want_grads = (list(grads) if want_grads is None
                      else [a + g for a, g in zip(want_grads, grads)])
    loss = step(batch, gen)
    assert step.step == 1 and step.optimizer.count == 1
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    for p, p0, g in zip(step.params.values(), before, want_grads):
        torch.testing.assert_close(p.detach(), p0 - 0.1 * g / 2)


def test_draws_follow_the_reference(rng):
    """t = floor(U * 1000) in [0, 999], noise shaped like z, and one
    grounding-drop draw for the whole batch."""
    cfg = pts.TrainStepConfig(unet_cfg=UNetConfig(**SMALL_UNET),
                              schedule=port_schedule("linear", 1000, 0.00085, 0.012),
                              grounding_drop_prob=0.5)
    gen = torch.Generator().manual_seed(0)
    z = torch.zeros(64, 4, 8, 8)
    keeps = []
    for _ in range(40):
        t, noise, keep = pts.draw(cfg, gen, z)
        assert t.dtype == torch.int64 and 0 <= int(t.min()) and int(t.max()) <= 999
        assert noise.shape == z.shape and keep.shape == ()
        keeps.append(float(keep))
    assert set(keeps) == {0.0, 1.0}


# ---------------------------------------------------------------------------
# optimizer and schedules


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_schedules_match_optax(schedule):
    kw = dict(learning_rate=3e-4, warmup_steps=2, total_steps=5,
              lr_schedule=schedule)
    want = jts._lr_schedule(jts.TrainStepConfig(unet_cfg=None, schedule=None, **kw))
    cfg = pts.TrainStepConfig(unet_cfg=None, schedule=None, **kw)
    for count in range(6):
        np.testing.assert_allclose(pts.learning_rate(cfg, count),
                                   float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("optimizer,weight_decay", [("adamw", 0.01), ("sgd", 0.0)])
def test_three_updates_match_optax(rng, optimizer, weight_decay):
    kw = dict(learning_rate=1e-2, weight_decay=weight_decay, warmup_steps=2,
              optimizer=optimizer)
    tx = jts.make_partitioned_optimizer(
        jts.TrainStepConfig(unet_cfg=None, schedule=None, **kw))
    shapes = {"w": (5, 3), "b": (3,), "alpha": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    state = tx.init(params)
    port = [_t(params[k]) for k in shapes]
    opt = pts.Optimizer(pts.TrainStepConfig(unet_cfg=None, schedule=None, **kw), port)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.update(port, [_t(grads[k]) for k in shapes])
        for p, k in zip(port, shapes):
            np.testing.assert_allclose(p.numpy(), np.asarray(params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.count == 3


# ---------------------------------------------------------------------------
# trainer, export, CLI


def _trainer_cfg(tmp_path, **kw):
    return TrainerConfig(output_root=str(tmp_path), name="t", batch_size=2,
                         total_iters=3, save_every_iters=2, log_every=1,
                         warmup_steps=1, max_boxes=30, max_relations=5, **kw)


def _port_models():
    return gligen_models_from_jax(jax_tiny_models(),
                                  HashTokenizer(max_length=8, vocab_size=512),
                                  device="cpu")


def test_trainer_runs_resumes_and_trains_only_rela_fuse(tmp_path):
    cfg = _trainer_cfg(tmp_path, enable_ema=True, ema_rate=0.5)
    models = _port_models()
    before = {k: v.clone() for k, v in models.unet_params.state_dict().items()}
    data = synthetic_layout_batches(cfg.batch_size, image_size=16, max_boxes=30)
    tr = DiffusionTrainer(cfg, data, models=models)
    tr.train()
    tr.close()
    run = tr.run_dir
    assert os.path.exists(os.path.join(run, "checkpoint_latest", "state.pt"))
    assert os.path.exists(os.path.join(run, "checkpoint_00000003", "config.json"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 3
    after = models.unet_params.state_dict()
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed and all("rela_fuse" in k for k in changed)
    assert set(tr.train_step.params) >= changed
    ema = tr.train_step.ema
    assert max(float((ema[k] - after[k]).abs().max()) for k in changed) > 0

    # relaunch under the same name: auto-resume from the saved step
    tr2 = DiffusionTrainer(cfg, data, models=_port_models())
    assert tr2.run_dir == run and tr2.starting_iter >= 2
    for k, p in tr2.train_step.params.items():
        assert torch.equal(p, after[k]), k
    assert tr2.train_step.optimizer.count == 3
    tr2.close()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    for kw in (dict(num_devices=2), dict(zero1_opt_state=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            DiffusionTrainer(_trainer_cfg(tmp_path, **kw), iter(()),
                             models=_port_models())


def test_export_matches_the_jax_exporter(tmp_path):
    jm = jax_tiny_models()
    pm = _port_models()
    ema = jax.tree.map(lambda a: np.asarray(a) * 0.5, jm["unet_params"])
    cfg_dict = {"name": "t", "unet_cfg": dataclasses.asdict(jm["unet_cfg"])}
    jax_export(str(tmp_path / "jax.pth"), jm["unet_params"], jm["vae_params"],
               jm["clip_params"], jm["schedule"], cfg_dict, iters=3,
               ema_unet_params=ema)
    export_gligen_checkpoint(
        str(tmp_path / "port.pth"), pm.unet_params.state_dict(),
        pm.vae_params.state_dict(), pm.clip_params.state_dict(), pm.schedule,
        cfg_dict, iters=3,
        ema_unet_sd=param_tree_from_jax(ema).state_dict())
    want = torch.load(tmp_path / "jax.pth", weights_only=False)
    got = torch.load(tmp_path / "port.pth", weights_only=False)
    assert set(got) == set(want)
    assert got["iters"] == want["iters"] == 3 and got["config_dict"] == cfg_dict
    for module in ("model", "text_encoder", "autoencoder", "diffusion", "ema"):
        assert set(got[module]) == set(want[module]), module
        for k, v in want[module].items():
            assert got[module][k].dtype == v.dtype, k
            torch.testing.assert_close(got[module][k], v, rtol=0, atol=0)


def test_cli_small_drive_and_refusals(tmp_path):
    argv = ["--small", "--synthetic", "--device", "cpu", "--batch_size", "2",
            "--total_iters", "3", "--save_every_iters", "2", "--warmup_steps", "1",
            "--output_root", str(tmp_path), "--name", "cli",
            "--export_reference_ckpt", "--sync_ckpt"]
    cli.main(argv)
    run = tmp_path / "cli" / "tag00"
    assert (run / "checkpoint_00000003" / "state.pt").exists()
    assert (run / "checkpoint_00000003.pth").exists()
    for extra in (["--multihost"], ["--zero1"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            cli.main(argv + extra)


def test_hash_tokenizer_small_vocab_stays_in_range():
    """The JAX package's HashTokenizer ignores a small vocab_size for word
    ids (1000 + hash % 39000): with the tiny training models' 512 tokens
    they fall outside the embedding table, and JAX's gather clamps every
    one to the EOT row. The port's copy gives the same ids, and its CLIP
    lookup stays in the table by the same clamp: the tiny encoder's
    outputs match JAX's (f32, 1e-5)."""
    texts = ["a dog chasing a frisbee in a park", "two cats on a couch"]
    jax_ids = JaxHashTokenizer(max_length=8, vocab_size=512)(texts)
    port_ids = HashTokenizer(max_length=8, vocab_size=512)(texts)
    assert jax_ids.max() >= 512
    np.testing.assert_array_equal(port_ids, jax_ids)
    np.testing.assert_array_equal(HashTokenizer()(texts), JaxHashTokenizer()(texts))

    jm = jax_tiny_models()
    want_hidden, want_pooled = jclip.clip_text_apply(
        jm["clip_params"], jm["clip_cfg"], jnp.asarray(jax_ids))
    pm = _port_models()
    hidden, pooled = clip_text_apply(pm.clip_params, pm.clip_cfg,
                                     torch.from_numpy(port_ids.astype(np.int64)))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=1e-5)
