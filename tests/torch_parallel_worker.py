"""One rank of the port's parallel tests on the CPU (gloo).

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py JOB DIR

``spawn_world`` starts the ranks so. Each job reads its inputs from DIR
(written by the test module), runs on every rank, and rank 0 saves what the
test reads to DIR/JOB.pt. This module imports torch only: the JAX side of
a comparison runs in the test process.

Jobs:
  jax    the bridged small bundle's sample_latents_tp ('heads',
         'spatial') on one request and sample_latents_sharded on two;
         the same request's sample_latents_tp (both styles) on the
         bundle's int8 UNet with DPM-Solver++, the guidance interval and
         the encoder cache; attention_with_projections under 'spatial'
         (N 1024); row-split GroupNorm, stride-1 and stride-2
         convolutions; the 'heads' GEGLU FF through K6's route (its plain
         version on the CPU) on a rank's inner slice.
  paths  port-only: the 'spatial' and 'heads' compositions with int8,
         DPM-Solver++, the guidance interval and the encoder cache against
         one process; generate_sharded against generate (PLMS, per-request
         seeds, DDIM at eta 0.5); bench --sharded, nss1k --sharded and
         txt2img's sharded sweep, each run through its main().
"""
from __future__ import annotations

import contextlib
import datetime
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PROMPTS = ["a dog next to a cat", "a cat on a chair", "a red ball", "a lamp"]
LAYOUTS = [([[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9]], ["dog", "cat"]),
           ([[0.2, 0.1, 0.6, 0.6]], ["cat"]),
           ([[0.3, 0.3, 0.7, 0.7]], ["ball"]),
           ([[0.6, 0.1, 0.9, 0.8]], ["lamp"])]
RELATIONS = [["dog next to cat"], ["cat on chair"], [], []]
COMPOSE = dict(steps=4, sampler="dpm", guidance_scale=7.5,
               alpha_type=(0.3, 0.0, 0.7), cfg_interval=(0.1, 0.85),
               encoder_cache_interval=2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank, one torch thread."""
    return dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                OMP_NUM_THREADS="1", PYTHONPATH=REPO)


def spawn_world(argv_tail, world: int = 2, env_extra=None, **popen):
    """Start ``world`` ranks of ``python ARGV_TAIL`` with torchrun's
    environment (and ``env_extra``); returns the Popen objects."""
    port = free_port()
    return [subprocess.Popen([sys.executable] + list(argv_tail),
                             env={**world_env(r, world, port),
                                  **(env_extra or {})}, cwd=REPO, **popen)
            for r in range(world)]


def wait_world(procs, timeout: float):
    """Wait for every rank (each within ``timeout`` s of the call); kill
    the rest and raise on a non-zero exit or a rank past its time."""
    deadline = time.monotonic() + timeout
    bad = []
    for r, p in enumerate(procs):
        try:
            rc = p.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            bad.append((r, rc))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if bad:
        raise RuntimeError(f"ranks failed (rank, exit): {bad}")


def set_alphas(tree, value: float = 0.5) -> None:
    """Open every gate (random init leaves them 0, hiding the fusers)."""
    for name, p in tree.named_parameters():
        if name.endswith(("alpha_attn", "alpha_dense")):
            p.data.fill_(value)


def bundle(dirname: str):
    """The small port bundle holding DIR/weights.pt's weights."""
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    pm = random_models(small=True, device="cpu", seed=1)
    for name, sd in torch.load(os.path.join(dirname, "weights.pt")).items():
        getattr(pm, name).load_state_dict(sd)
    return pm


def job_jax(mesh, dirname: str) -> dict:
    from layoutllm_t2i_torch.ops import nn
    from layoutllm_t2i_torch.ops.attention import attention_with_projections
    from layoutllm_t2i_torch.parallel import tp
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
    from layoutllm_t2i_torch.pipeline.loaders import quantize_unet_int8

    inp = torch.load(os.path.join(dirname, "inputs.pt"))
    pipe = InferencePipeline(bundle(dirname), steps=2, guidance_scale=7.5)
    qpipe = InferencePipeline(quantize_unet_int8(bundle(dirname), min_size=128),
                              **COMPOSE)
    out = {}
    for style in ("heads", "spatial"):
        out[style] = pipe.sample_latents_tp(mesh, inp["cond1"], inp["noise1"],
                                            style=style)
        out[f"compose_{style}"] = qpipe.sample_latents_tp(
            mesh, inp["cond1"], inp["noise1"], style=style)
    # K6's route for a 'heads' FF, which the card takes (its plain version
    # on these CPU tensors), at a site K6 is eligible for
    f, real, k6 = inp["ff"], (nn._pallas_ffn_enabled, nn.ffn_geglu), []
    nn._pallas_ffn_enabled = lambda x: True
    nn.ffn_geglu = lambda *a: k6.append(tuple(a[3].shape)) or real[1](*a)
    try:
        with tp.tp_mode(mesh, "heads"):
            out["ff_heads"] = nn.geglu_ff(f["p"], f["x"])
    finally:
        nn._pallas_ffn_enabled, nn.ffn_geglu = real
    out["ff_heads_k6"] = k6
    out["sharded"] = pipe.sample_latents_sharded(mesh, inp["cond2"],
                                                 inp["noise2"])
    a = inp["attention"]
    with tp.tp_mode(mesh, "spatial"):
        n = a["x"].shape[1]
        blk = slice(mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size)
        xl = a["x"][:, blk]
        y = attention_with_projections(a["p"], xl, xl, xl, a["heads"],
                                       kv_rows=(xl.shape[1], n))
        out["attention"] = tp.gather_tokens(y, n)
        for name, case in inp["convs"].items():
            x = tp.shard_rows(case["x"])
            out[f"conv_{name}_split"] = tp.row_block(x) is not None
            y = nn.conv2d(case["p"], x, stride=case["stride"])
            out[f"conv_{name}"] = tp.gather_rows(y)
        g = inp["group_norm"]
        x = tp.shard_rows(g["x"])
        out["group_norm_split"] = tp.row_block(x) is not None
        out["group_norm"] = tp.gather_rows(
            nn.group_norm(g["p"], x, g["groups"], g["eps"], silu=True))
    return out


def _cli_stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def job_paths(mesh, dirname: str) -> dict:
    from layoutllm_t2i_torch.cli import bench, txt2img
    from layoutllm_t2i_torch.eval import nss1k
    from layoutllm_t2i_torch.parallel.mesh import replicate
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
    from layoutllm_t2i_torch.pipeline.loaders import (quantize_unet_int8,
                                                      random_models)

    out = {}
    models = random_models(small=True, device="cpu", seed=0)
    set_alphas(models.unet_params)
    qmodels = quantize_unet_int8(random_models(small=True, device="cpu",
                                               seed=0), min_size=128)
    set_alphas(qmodels.unet_params)
    pipe = InferencePipeline(qmodels, **COMPOSE)
    cond = replicate(mesh, pipe.build_cond(PROMPTS[:1], LAYOUTS[:1],
                                           RELATIONS[:1]))
    noise = np.random.default_rng(3).standard_normal(
        (1, 8, 8, 4)).astype(np.float32)
    out["compose_ref"] = pipe.sample_latents(cond, noise)
    for style in ("spatial", "heads"):
        out[f"compose_{style}"] = pipe.sample_latents_tp(mesh, cond, noise,
                                                         style=style)
    for name, kw, gen_kw in (
            ("plms", dict(steps=3), dict(seed=5)),
            ("seeds", dict(steps=3), dict(seeds=[11, 12, 13, 14])),
            ("ddim", dict(steps=3, sampler="ddim", eta=0.5), dict(seed=5))):
        p = InferencePipeline(models, guidance_scale=7.5,
                              alpha_type=(0.5, 0.0, 0.5), **kw)
        out[f"sharded_{name}"] = p.generate_sharded(mesh, PROMPTS, LAYOUTS,
                                                    RELATIONS, **gen_kw)
        out[f"single_{name}"] = p.generate(PROMPTS, LAYOUTS, RELATIONS,
                                           **gen_kw)
    out["bench"] = _cli_stdout(bench.main, [
        "--sharded", "--small", "--device", "cpu", "--batch", "2",
        "--iters", "1", "--steps", "2", "--no_fast"])
    out["nss1k"] = _cli_stdout(nss1k.main, [
        "--data_path", os.path.join(dirname, "split.json"), "--small",
        "--device", "cpu", "--steps", "2", "--batch_size", "2", "--sharded"])
    folder = os.path.join(dirname, "txt2img")
    out["txt2img"] = txt2img.main([
        "--small", "--device", "cpu", "--prompt", "a dog",
        "--layout", "dog:[0.1,0.2,0.5,0.6]", "--sample_steps", "2",
        "--num_per_prompt", "2", "--folder", folder])
    out["txt2img_files"] = sorted(os.listdir(folder)) if mesh.rank == 0 else []
    return out


JOBS = {"jax": job_jax, "paths": job_paths}


def main(argv) -> int:
    job, dirname = argv
    torch.set_num_threads(1)
    from layoutllm_t2i_torch.parallel.mesh import sync_global_devices
    from layoutllm_t2i_torch.parallel.tp import tp_mesh

    mesh = tp_mesh(device="cpu", timeout=datetime.timedelta(seconds=240))
    out = JOBS[job](mesh, dirname)
    if mesh.rank == 0:
        torch.save(out, os.path.join(dirname, f"{job}.pt"))
    sync_global_devices()   # rank 0's file is written before any rank exits
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
