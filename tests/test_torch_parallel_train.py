"""Data-parallel training (parallel/ for training) at world 2 on the CPU.

Two ranks of ``tests/torch_parallel_worker.py`` (job ``train``, gloo, one
torch thread each) run once for the module on the tiny training bundle of
``tests/test_torch_train.py`` (``jax_tiny_models``, every gate at 0.5,
bridged by ``gligen_models_from_jax``), while this process computes the
JAX side and the world-1 runs. What is held:

* the ranks' all-reduced ``rela_fuse`` gradients, each rank on its rows at
  given draws, against ``jax.value_and_grad`` of the JAX loss on the whole
  global batch (1e-4 of the largest gradient, as
  ``test_loss_and_rela_fuse_grads_match_jax``);
* two ZeRO-1 AdamW updates made from the ranks' blocks against
  ``optax.adamw`` on the whole leaves (1e-6, as
  ``test_three_updates_match_optax``);
* DiffusionTrainer at world 2 against world 1 on the same global batches
  (``tests/test_zero1.py``'s 1e-5): plain DP (``rela_fuse``, AdamW, 3
  steps; the logged losses too), ZeRO-1 with ``accum_steps=2`` (under
  ``'all'``, but for elements whose world-1 gradient is near AdamW's eps);
  ZeRO-1
  ``'all'`` bit-equal to DP ``'all'`` at world 2, its moments and EMA each
  rank's ``zero1_dim`` block, the 0-d gates whole;
* a planted fault, every rank drawing noise for its own rows alone, lies
  outside the bound; the real draws are the global draw's rows;
* ``prepare_batch`` on a rank's rows against one process on the global
  batch (the counterpart of the slow JAX ``tests/test_multihost.py``);
* a ZeRO-1 checkpoint written at world 2 resumed at world 1 and the other
  way round: the next step equals the one the run that wrote it takes;
* one ``tagNN`` run directory, rank 0 alone saving; the training CLI with
  ``--zero1 --multihost --backend gloo`` at world 2.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from layoutllm_t2i_tpu.diffusion import ddpm as jddpm
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.training import train_step as jts

from test_torch_train import jax_tiny_models, set_alphas

from layoutllm_t2i_torch.checkpoint.from_jax import (gligen_models_from_jax,
                                                     torch_layout)
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.parallel.mesh import zero1_dim
from layoutllm_t2i_torch.training import diffusion_trainer as dt
from layoutllm_t2i_torch.training import train_step as pts
from layoutllm_t2i_torch.utils.trees import flatten_tree
from torch_parallel_worker import (TRAIN, next_step, rank_batches, spawn_world,
                                   stable_tokenizer, train_models, trained,
                                   wait_world)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WORLD_TOL = 1e-5     # tests/test_zero1.py
GRAD_TOL = 1e-4      # of the largest gradient
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
ADAMW_EPS = 1e-8     # training/train_step.py's AdamW
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
OPT_SHAPES = {"w": (8, 4), "u": (4, 6), "b": (3, 5), "c": (16,), "g": ()}
OPT_CFG = dict(learning_rate=1e-2, weight_decay=0.01, warmup_steps=2)
CKPT = dict(zero1_opt_state=True, enable_ema=True, ema_rate=0.9)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def world1(d, root, name, grads=None, **kw):
    """A finished world-1 DiffusionTrainer on the seeded global batches, on
    the bundle the ranks load (its parameters in the same order).
    ``grads``: a list that each step's gradients, as the update takes
    them, are appended to."""
    cfg = dt.TrainerConfig(output_root=str(d / root), name=name,
                           **{**TRAIN, **kw})
    tr = dt.DiffusionTrainer(cfg, rank_batches(cfg.batch_size,
                                               np.arange(cfg.batch_size)),
                             models=train_models(str(d)))
    if grads is not None:
        update = tr.train_step.update

        def spy(g):
            grads.append([x.detach().clone() for x in g])
            update(g)
        tr.train_step.update = spy
    tr.train()
    tr.close()
    return tr


def grad_inputs(rng, b=4):
    """A global batch of the tiny geometry and its draws, NHWC for JAX."""
    boxes = np.zeros((b, 30, 4), np.float32)
    boxes[:, :2] = [[0.1, 0.2, 0.6, 0.9], [0.5, 0.1, 0.95, 0.6]]
    masks = np.zeros((b, 30), np.float32)
    masks[:, :2] = 1
    return dict(z=rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
                context=rng.standard_normal((b, 8, 32)).astype(np.float32),
                boxes=boxes, masks=masks,
                phrase_embeddings=rng.standard_normal((b, 30, 32)).astype(np.float32),
                relations=rng.standard_normal((b, 5, 32)).astype(np.float32),
                t=np.asarray([901, 41, 500, 7]),
                noise=rng.standard_normal((b, 8, 8, 4)).astype(np.float32))


def jax_grads(jm, g):
    train, frozen = jts.partition_params(jm["unet_params"], jts.rela_fuse_only)

    def loss(train_):
        p = jts.combine_params(train_, frozen)
        xn = jddpm.q_sample(jm["schedule"], jnp.asarray(g["z"]),
                            jnp.asarray(g["t"]), jnp.asarray(g["noise"]))
        eps = junet.unet_apply(p, jm["unet_cfg"], xn, jnp.asarray(g["t"]),
                               jnp.asarray(g["context"]), jnp.asarray(g["boxes"]),
                               jnp.asarray(g["masks"]),
                               jnp.asarray(g["phrase_embeddings"]),
                               jnp.asarray(g["relations"]))
        return jnp.mean((eps - jnp.asarray(g["noise"])) ** 2)

    value, grads = jax.jit(jax.value_and_grad(loss))(train)
    return float(value), {k: torch_layout(k, np.asarray(v))
                          for k, v in flatten_tree(grads).items() if v is not None}


def optax_updates(o):
    tx = optax.adamw(jts._lr_schedule(jts.TrainStepConfig(
        unet_cfg=None, schedule=None, **OPT_CFG)),
        weight_decay=OPT_CFG["weight_decay"])
    params = {k: v.numpy() for k, v in o["params"].items()}
    state = tx.init(params)
    for grads in o["grads"]:
        updates, state = tx.update({k: v.numpy() for k, v in grads.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
    return params, state[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the two ranks, compute the JAX side and the world-1 runs
    meanwhile; returns (the ranks' results, this process's, the dir)."""
    d = tmp_path_factory.mktemp("parallel_train")
    jm = jax_tiny_models()
    set_alphas(jm["unet_params"], 0.5)
    pm = gligen_models_from_jax(jm, stable_tokenizer(), device="cpu")
    torch.save({name: getattr(pm, name).state_dict()
                for name in ("unet_params", "vae_params", "clip_params")},
               d / "train_weights.pt")
    rng = np.random.default_rng(0)
    g = grad_inputs(rng)
    o = {"cfg": OPT_CFG,
         "params": {k: _t(rng.standard_normal(s).astype(np.float32))
                    for k, s in OPT_SHAPES.items()},
         "grads": [{k: _t(rng.standard_normal(s).astype(np.float32))
                    for k, s in OPT_SHAPES.items()} for _ in range(2)]}
    prep_batch = next(rank_batches(TRAIN["batch_size"],
                                   np.arange(TRAIN["batch_size"])))
    torch.save({
        "grads": {"batch": {k: (pnn.nhwc_to_nchw(_t(g[k])) if k == "z"
                                else _t(g[k]))
                            for k in ("z", "context", "boxes", "masks",
                                      "phrase_embeddings", "relations")},
                  "t": _t(g["t"]), "noise": pnn.nhwc_to_nchw(_t(g["noise"])),
                  "keep": torch.tensor(1.0)},
        "opt": o, "prep_batch": prep_batch}, d / "train_inputs.pt")
    # the world-1 checkpoint the ranks resume from, and the step its run
    # takes next
    ours = {}
    b = world1(d, "ckpt_w1", "b", total_iters=2, **CKPT)
    ours["b_next"] = next_step(b)
    del b
    procs = spawn_world([WORKER, "train", str(d)],
                        env_extra={"PYTHONHASHSEED": "0"})
    try:
        ours["jax_loss"], ours["jax_grads"] = jax_grads(jm, g)
        ours["optax"] = optax_updates(o)
        dp = world1(d, "w1", "dp")
        ours["dp"] = trained(dp)
        with open(os.path.join(dp.run_dir, "metrics.jsonl")) as f:
            ours["dp_losses"] = [json.loads(line)["loss"] for line in f]
        for mode in ("rela_fuse", "all"):
            grads = []
            tr = world1(d, "w1", f"z1_accum_{mode}", grads=grads,
                        accum_steps=2, trainable_mode=mode)
            ours[f"z1_accum_{mode}"] = trained(tr)
            # each element's largest |gradient| over the steps
            ours[f"z1_accum_{mode}_grad_max"] = dict(zip(
                tr.train_step.params,
                (torch.stack(gs).abs().amax(0) for gs in zip(*grads))))
            del tr
        tr = dt.DiffusionTrainer(dt.TrainerConfig(
            output_root=str(d / "w1"), name="prep", **TRAIN), iter(()),
            models=train_models(str(d)))
        tr.generator.manual_seed(5)
        ours["prep"] = tr.prepare_batch(prep_batch)
        tr.close()
        ours["draw"] = pts.draw(pts.TrainStepConfig(unet_cfg=None,
                                                    schedule=pm.schedule),
                                torch.Generator().manual_seed(11),
                                torch.zeros(4, 4, 8, 8))
        wait_world(procs, timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = torch.load(d / "train.pt", weights_only=False)
    # a world-1 run resuming from the ranks' ZeRO-1 checkpoint
    ours["a_resumed"] = trained(world1(d, "ckpt_w2", "a", **CKPT))
    return ranks, ours, d


def assert_close_params(got, want, tol=WORLD_TOL):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def test_allreduced_grads_match_jax_global_batch(world):
    ranks, ours, _ = world
    want = ours["jax_grads"]
    assert set(ranks["grads"]) == set(want) and len(want) > 20
    np.testing.assert_allclose(float(ranks["loss"]), ours["jax_loss"], rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in want.values())
    assert scale > 0
    for name, g in ranks["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_zero1_adamw_updates_match_optax(world):
    """Two updates, each rank on its zero1_dim blocks (the (3, 5) and 0-d
    leaves whole), gathered: the masters and the checkpoint's whole moments
    against optax.adamw."""
    ranks, ours, _ = world
    params, adam = ours["optax"]
    for k in OPT_SHAPES:
        np.testing.assert_allclose(ranks["opt_params"][k].numpy(),
                                   np.asarray(params[k]), err_msg=k, **OPT_TOL)
    state = ranks["opt_state"]
    assert state["opt"]["count"] == 2
    for i, k in enumerate(OPT_SHAPES):
        for key, want in (("mu", adam.mu), ("nu", adam.nu)):
            np.testing.assert_allclose(state["opt"][key][i].numpy(),
                                       np.asarray(want[k]), err_msg=k, **OPT_TOL)


def test_dp_matches_world1_on_the_global_batch(world):
    ranks, ours, _ = world
    assert_close_params(ranks["dp"], ours["dp"])
    assert any("rela_fuse" in n for n in ours["dp"])
    with open(os.path.join(ranks["run_dir_dp"], "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == len(ours["dp_losses"]) == TRAIN["total_iters"]
    np.testing.assert_allclose(losses, ours["dp_losses"], rtol=1e-6)


def test_zero1_all_bit_equals_dp_all_and_splits_its_state(world):
    ranks, _, _ = world
    assert ranks["z1_same_by_rank"] == [True, True]
    for rank, blocks in enumerate(ranks["z1_blocks"]):
        split = 0
        for name, (shape, mu, ema, d) in blocks.items():
            assert d == zero1_dim(shape, 2), name
            want = list(shape)
            if d is not None:
                want[d] //= 2
                split += 1
            assert list(mu) == want and list(ema) == want, (rank, name)
            if shape == ():
                assert d is None and mu == ()
        assert split > 0
    assert any(shape == () for shape, *_ in ranks["z1_blocks"][0].values())
    # the checkpoint gathers the blocks: the one-process format, bit-equal
    for key in ("mu", "nu"):
        for a, b in zip(ranks["z1_state"]["opt"][key], ranks["dp_state"]["opt"][key]):
            assert a.shape == b.shape and torch.equal(a, b)
    for name, e in ranks["dp_state"]["ema"].items():
        assert torch.equal(ranks["z1_state"]["ema"][name], e), name


@pytest.mark.parametrize("mode", ["rela_fuse", "all"])
def test_zero1_with_accumulation_matches_world1(world, mode):
    """ZeRO-1 at world 2 with two microbatches a step (one row a rank each)
    against world 1 with two, every element within 1e-5 but those whose
    world-1 gradient stayed under AdamW's eps at every step: there the
    step g / (|g| + eps) turns on the gradient's rounding, so reassociated
    sums change its size or sign (under 'all', 78 elements of ten biases
    whose gradients are ~1e-9 read 1e-5 to 3e-5 apart). Those must be
    under 1 % of the elements (0.64 % under 'all', where some leaves of
    the tiny random model get almost no gradient; 0.08 % under
    'rela_fuse'), and stay within 2 lr a step, which AdamW cannot leave."""
    ranks, ours, _ = world
    got, want = ranks[f"z1_accum_{mode}"], ours[f"z1_accum_{mode}"]
    near_zero = {n: g < ADAMW_EPS
                 for n, g in ours[f"z1_accum_{mode}_grad_max"].items()}
    assert list(got) == list(want) == list(near_zero)
    bound = 2 * dt.TrainerConfig().base_learning_rate * TRAIN["total_iters"]
    for name, p in want.items():
        keep = ~near_zero[name]
        np.testing.assert_allclose(got[name][keep].numpy(), p[keep].numpy(),
                                   rtol=WORLD_TOL, atol=WORLD_TOL, err_msg=name)
        assert float((got[name] - p).abs().max()) <= bound, name
    left_out = sum(int(m.sum()) for m in near_zero.values())
    total = sum(m.numel() for m in near_zero.values())
    assert left_out <= 1e-2 * total, (left_out, total)


def test_draws_are_the_global_draws_rows_and_a_local_draw_is_caught(world):
    ranks, ours, _ = world
    t, noise, keep = ours["draw"]
    got = ranks["draw"]
    assert torch.equal(got["t"], t) and torch.equal(got["noise"], noise)
    assert got["keep"] == [float(keep)] * 2
    assert not torch.equal(got["noise"][:2], got["noise"][2:])
    # every rank drawing for its own rows alone: both ranks get the same
    # noise, and the run leaves world 1's bound
    worst = max(float((ranks["planted"][n] - p).abs().max())
                for n, p in ours["dp"].items())
    assert worst > 10 * WORLD_TOL


def test_prepare_batch_on_rank_rows_matches_one_process(world):
    ranks, ours, _ = world
    assert set(ranks["prep"]) == set(ours["prep"])
    for k, v in ours["prep"].items():
        np.testing.assert_allclose(ranks["prep"][k].numpy(), v.numpy(),
                                   rtol=WORLD_TOL, atol=WORLD_TOL, err_msg=k)


@pytest.mark.parametrize("direction", ["world2_to_world1", "world1_to_world2"])
def test_zero1_checkpoint_resumes_across_world_sizes(world, direction):
    ranks, ours, _ = world
    if direction == "world2_to_world1":
        assert_close_params(ours["a_resumed"], ranks["a_next"])
    else:
        assert ranks["b_start"] == 2
        assert_close_params(ranks["b_resumed"], ours["b_next"])


def test_one_run_directory_and_rank0_alone_writes(world):
    ranks, _, d = world
    for root, name in (("runs", "dp"), ("runs", "all_z1"), ("ckpt_w2", "a"),
                       ("ckpt_w1", "b"), ("cli", "cli")):
        assert sorted(os.listdir(d / root / name)) == ["tag00"], (root, name)
    n0, n1 = ranks["saves_by_rank"]
    assert n0 > 0 and n1 == 0
    assert ranks["logger_by_rank"] == ["Logger", "_Quiet"]


def test_cli_trains_at_world2_with_zero1_multihost(world):
    _, _, d = world
    run = d / "cli" / "cli" / "tag00"
    assert (run / "checkpoint_00000002" / "state.pt").exists()
    with open(run / "metrics.jsonl") as f:   # log_every 10: step 0 alone
        assert [json.loads(line)["step"] for line in f] == [0]
    state = torch.load(run / "checkpoint_00000002" / "state.pt",
                       weights_only=True)["state"]
    assert state["step"] == 2 and state["opt"]["count"] == 2
    assert [m.shape for m in state["opt"]["mu"]] == [
        p.shape for p in state["params"].values()]


def test_chip_smoke_train_dp_child_rehearses_on_the_cpu(tmp_path):
    """chip_smoke.py phase train-dp's ranks at the small geometry on the
    CPU (gloo): world 1, then world 2 plain and ZeRO-1, held by the
    phase's own checks but for the launch counts (no kernel launches on
    the CPU). One hash seed for every process, as the phase's
    ``parallel_env`` sets it: the small bundle's hash tokenizer salts its
    words per process, and world 1 must see world 2's conditioning."""
    import chip_smoke

    code = ("import sys, torch; torch.set_num_threads(1); import chip_smoke; "
            f"sys.exit(chip_smoke.train_dp_child('gloo', {str(tmp_path)!r}, "
            "'cpu', True))")
    recs = []
    for world in (1, 2):
        wait_world(spawn_world(["-c", code], world=world,
                               env_extra={"PYTHONHASHSEED": "0"}), timeout=240)
        recs += [json.loads((tmp_path / f"w{world}_rank{r}.json").read_text())
                 for r in range(world)]
    assert chip_smoke.train_dp_faults(recs, launches=False) == []
    w2 = recs[1]["runs"]
    assert w2["plain"]["grad_rel_l2_err"] > 0      # a real comparison
    assert w2["zero1"]["bit_equal_to_plain"]
    assert 2 * w2["zero1"]["moment_bytes"] <= 1.001 * w2["plain"]["moment_bytes"]
    assert recs[1]["local_batch"] == 4 and recs[0]["local_batch"] == 8
