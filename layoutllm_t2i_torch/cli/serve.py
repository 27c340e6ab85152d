"""Serving CLI: the micro-batched HTTP generation server
(layoutllm_t2i_tpu/cli/serve.py).

    python -m layoutllm_t2i_torch.cli.serve --ckpt gligen.pth --port 8501 \\
        --batch 8 --max_delay_ms 80 --fast

    curl -s localhost:8501/generate -d '{"prompt": "a dog in a park",
        "layout": [{"phrase": "dog", "box": [0.2, 0.4, 0.5, 0.9]}]}' \\
        -o out.png
    curl -s localhost:8501/metrics

The model runs on the card (``--device``, default CUDA); ``--small
--device cpu`` serves a tiny random-weight model on the CPU for smoke
tests. Requests coalesce into fixed ``--batch`` dispatches (serving/
batcher.py). ``--fast`` is the preset of pipeline/presets.py.

``--tp`` is the tensor-parallel latency mode: each image's compute is
split over every rank of the group (parallel/tp.py, 'spatial' as in the
JAX server), one process a rank, launched by torchrun:

    torchrun --nproc_per_node 2 -m layoutllm_t2i_torch.cli.serve --tp

Rank 0 serves HTTP and broadcasts each batch; the other ranks follow it
(serving/tp.py) and exit 0 when rank 0 shuts down. A batch that fails on
any rank ends the group: every rank exits non-zero. ``--batch`` is 1
under ``--tp`` unless given. Ranks that share one card need ``--device
cuda:0 --tp_backend gloo`` (NCCL refuses two ranks on one device);
``--small --device cpu --tp`` runs the group on the CPU over gloo.
"""
from __future__ import annotations

import argparse
import datetime
import signal
import threading

from ..pipeline.presets import apply_fast_preset

# the group's collective timeout under --tp: a follower waits in a
# broadcast for rank 0's next request, however long the server idles
TP_TIMEOUT = datetime.timedelta(days=7)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None,
                    help="a reference GLIGEN .pth (random weights without)")
    ap.add_argument("--small", action="store_true",
                    help="tiny random-weight models for smoke runs")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--max_delay_ms", type=float, default=80.0)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--sampler", type=str, default="plms",
                    choices=["plms", "ddim", "dpm"],
                    help="dpm = DPM-Solver++(2M), PLMS-50-class at ~15-20 "
                         "steps")
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument("--tp", action="store_true",
                    help="tensor-parallel latency mode over every rank of "
                         "the torchrun group; --batch 1 unless given")
    ap.add_argument("--tp_backend", type=str, default=None,
                    choices=["nccl", "gloo"],
                    help="default NCCL on CUDA, gloo on the CPU; ranks "
                         "sharing one card need gloo")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 UNet (ops/quant.py); "
                         "LLT2I_FFN_INT8=1 routes its FF sites to K7")
    ap.add_argument("--cache_encoder", type=int, default=0,
                    help="encoder propagation interval (approximate, "
                         "arXiv:2312.09608; 0/1 = exact)")
    ap.add_argument("--cfg_interval", type=str, default=None,
                    help="LO,HI step fractions where CFG applies "
                         "(arXiv:2404.07724)")
    ap.add_argument("--fast", action="store_true",
                    help="speed preset (pipeline/presets.py): DPM-Solver++ "
                         "15 steps + guidance interval 0,0.75 + encoder "
                         "cache 2; explicit --sampler/--steps/--cfg_interval/"
                         "--cache_encoder override its pieces")
    return ap.parse_args(argv)


def build_pipeline(args, device=None):
    """The InferencePipeline the flags describe, on ``device`` (default
    ``--device``). Returns (pipeline, steps)."""
    if args.fast:
        apply_fast_preset(args)

    from ..pipeline.inference import InferencePipeline, parse_cfg_interval
    from ..pipeline.loaders import (load_models_from_gligen_ckpt,
                                    quantize_unet_int8, random_models)

    device = device or args.device
    cfg_interval = parse_cfg_interval(args.cfg_interval)
    if args.ckpt:
        models = load_models_from_gligen_ckpt(args.ckpt, device=device)
    else:
        models = random_models(small=args.small, device=device)
    if args.int8:
        models = quantize_unet_int8(models)
    steps = args.steps or (8 if args.small else 50)
    pipe = InferencePipeline(models, steps=steps, sampler=args.sampler,
                             guidance_scale=args.guidance_scale,
                             encoder_cache_interval=args.cache_encoder,
                             cfg_interval=cfg_interval)
    return pipe, steps


def build_server(args, pipe=None, steps=None):
    """The GenerationServer the flags describe (around ``pipe`` with its
    ``steps``, default build_pipeline's), warming up in the background.
    Returns (server, steps)."""
    from ..serving.server import GenerationServer

    if pipe is None:
        pipe, steps = build_pipeline(args)
    batch = args.batch or (1 if args.tp else 4)
    srv = GenerationServer(pipe, batch_size=batch,
                           max_delay_ms=args.max_delay_ms, host=args.host,
                           port=args.port, warmup=not args.no_warmup)
    return srv, steps


def serve(srv, steps, args, stop=None) -> None:
    """Serve until ^C, or until ``stop`` (a threading.Event) is set."""
    print(f"serving on {args.host}:{srv.port} (batch={srv.batcher.batch_size}, "
          f"steps={steps}, sampler={args.sampler})", flush=True)
    try:
        srv.start_background()
        (stop or threading.Event()).wait()
    except KeyboardInterrupt:
        # shut down once: torchrun passes a ^C on to every rank again
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    finally:
        srv.shutdown()


def main_tp(args) -> None:
    """--tp: rank 0 serves through a TPPipeAdapter, the others follow. A
    failed batch ends the group and every rank's process with an error."""
    import torch.distributed as dist

    from ..parallel.tp import tp_mesh
    from ..serving.tp import TPPipeAdapter, follow

    mesh = tp_mesh(device=args.device, backend=args.tp_backend,
                   timeout=TP_TIMEOUT)
    try:
        pipe, steps = build_pipeline(args, device=mesh.device)
        if mesh.rank != 0:
            # a follower stops on rank 0's broadcast, not on a ^C of its own
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            n = follow(pipe, mesh)
            print(f"rank {mesh.rank}: {n} batches, stopped", flush=True)
        else:
            adapter = TPPipeAdapter(pipe, mesh)
            try:
                srv, _ = build_server(args, adapter, steps)
                print(f"tensor-parallel: {mesh.size} ranks, spatial, "
                      f"{mesh.backend} on {mesh.device}", flush=True)
                serve(srv, steps, args, stop=adapter.failed)
            finally:
                adapter.close()
            if adapter.failure:
                raise SystemExit(f"serve --tp: {adapter.failure}")
        # leave together: neither rank tears its group down while the
        # other is still in the stop's broadcast
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    if args.tp:
        return main_tp(args)
    srv, steps = build_server(args)
    serve(srv, steps, args)


if __name__ == "__main__":
    main()
