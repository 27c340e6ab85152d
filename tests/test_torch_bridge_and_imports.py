"""The port's weights bridge, its import boundary and its device rule.

* Every tensor of the JAX package's parameter trees loads ``strict=True``
  into the port's modules, with the layout undone (conv HWIO -> OIHW,
  linear (in, out) -> (out, in), embedding tables untouched); at full SD-1.4
  geometry the two packages' initializers name and shape every tensor alike.
* No file of ``layoutllm_t2i_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``layoutllm_t2i_tpu`` (an AST scan, so a lazy import inside a
  function counts too), and every module of the port, the training slice's
  included, imports in a process where importing JAX fails.
* An entry point called without ``device`` where CUDA is missing raises
  instead of running on the CPU, and a CPU tensor never counts a launch.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from layoutllm_t2i_tpu.models import clip_text as jclip
from layoutllm_t2i_tpu.models import initializers as jinit
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.models import vae as jvae
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.checkpoint.from_jax import (
    load_from_jax, state_dict_from_jax, torch_layout,
)
from layoutllm_t2i_torch.device import resolve_device
from layoutllm_t2i_torch.kernels.dispatch import use_kernel
from layoutllm_t2i_torch.models import clip_text as pclip
from layoutllm_t2i_torch.models import unet as punet
from layoutllm_t2i_torch.models import vae as pvae
from layoutllm_t2i_torch.models.initializers import Init
from layoutllm_t2i_torch.pipeline.inference import GligenModels
from layoutllm_t2i_torch.pipeline.loaders import random_models
from layoutllm_t2i_torch.utils.trees import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "layoutllm_t2i_tpu")


@pytest.fixture(scope="module")
def small_pair():
    jm = jax_random_models(seed=0, small=True)
    pm = random_models(small=True, device="cpu", seed=1)
    return jm, pm


@pytest.mark.parametrize("name", ["unet_params", "vae_params", "clip_params"])
def test_jax_params_load_strict(small_pair, name):
    jm, pm = small_pair
    jtree, module = getattr(jm, name), getattr(pm, name)
    load_from_jax(module, jtree)  # strict=True: a missing or extra name raises
    flat = {k: np.asarray(v) for k, v in flatten_tree(jtree).items()}
    sd = module.state_dict()
    assert set(sd) == set(flat)
    for key, a in flat.items():
        t = sd[key].numpy()
        if a.ndim == 4:
            expect = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2 and key.endswith(".weight") and "embedding" not in key:
            expect = a.T
        else:
            expect = a
        np.testing.assert_array_equal(t, expect, err_msg=key)


def test_bridge_layouts():
    tree = {"conv": {"weight": np.arange(2 * 3 * 4 * 5, dtype=np.float32)
                     .reshape(2, 3, 4, 5)},
            "lin": {"weight": np.ones((6, 7), np.float32),
                    "bias": np.zeros(7, np.float32)},
            "token_embedding": {"weight": np.ones((9, 6), np.float32)},
            "alpha_attn": np.float32(0.25)}
    sd = state_dict_from_jax(tree)
    assert sd["conv.weight"].shape == (5, 4, 2, 3)
    assert sd["conv.weight"][1, 2, 0, 1] == tree["conv"]["weight"][0, 1, 2, 1]
    assert sd["lin.weight"].shape == (7, 6)
    assert sd["lin.bias"].shape == (7,)
    assert sd["token_embedding.weight"].shape == (9, 6)
    assert sd["alpha_attn"].shape == () and float(sd["alpha_attn"]) == 0.25


class _ShapeInit(Init):
    """Initializer that makes meta tensors: names and shapes, no memory."""

    def __init__(self):
        super().__init__(gen=None, device=torch.device("meta"))

    def uniform(self, shape, bound):
        return torch.empty(shape, device="meta")

    normal = uniform

    def full(self, shape, value):
        return torch.empty(shape, device="meta")


def _no_memory(shape):
    return np.broadcast_to(np.float32(0), shape)


@pytest.mark.parametrize("which", ["unet", "vae", "clip"])
def test_full_geometry_names_and_shapes(monkeypatch, which):
    # the JAX initializers draw on the host; zero-stride leaves keep the
    # full SD-1.4 trees (about a billion values) out of memory
    monkeypatch.setattr(jinit, "linear_p", lambda key, din, dout, bias=True, **_: (
        {"weight": _no_memory((din, dout)), "bias": _no_memory((dout,))}
        if bias else {"weight": _no_memory((din, dout))}))
    monkeypatch.setattr(jinit, "conv_p", lambda key, kh, kw, cin, cout, bias=True, **_: (
        {"weight": _no_memory((kh, kw, cin, cout)), "bias": _no_memory((cout,))}
        if bias else {"weight": _no_memory((kh, kw, cin, cout))}))
    monkeypatch.setattr(jinit, "normal_p", lambda key, shape, scale=0.02, **_: _no_memory(shape))
    key = jax.random.PRNGKey(0)
    if which == "unet":
        jtree = junet.init_unet_params(key, junet.UNetConfig())
        ptree = punet.init_unet_params(_ShapeInit(), punet.UNetConfig())
    elif which == "vae":
        jtree = jvae.init_vae_params(key, jvae.VAEConfig())
        ptree = pvae.init_vae_params(_ShapeInit(), pvae.VAEConfig())
    else:
        jtree = jclip.init_clip_text_params(key, jclip.CLIPTextConfig())
        ptree = pclip.init_clip_text_params(_ShapeInit(), pclip.CLIPTextConfig())
    jflat = {k: torch_layout(k, v).shape for k, v in flatten_tree(jtree).items()}
    pflat = {k: tuple(v.shape) for k, v in flatten_tree(ptree).items()}
    assert len(pflat) > 100
    assert pflat == jflat


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax():
    files = sorted((REPO / "layoutllm_t2i_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


TRAINING_MODULES = (
    "checkpoint.async_io", "checkpoint.export", "checkpoint.io",
    "cli.train_diffusion", "data.synthetic", "diffusion.ddpm",
    "pipeline.scene_graph", "training.diffusion_trainer",
    "training.train_step", "utils.logging",
)
# the fast preset and the serving path, with the .pth loader behind it
SERVING_MODULES = (
    "checkpoint.convert", "checkpoint.tools", "cli.serve", "pipeline.presets",
    "serving.batcher", "serving.server",
)
# the port bench and the generation CLIs, with what they stand on
GENERATION_MODULES = (
    "cli.bench", "cli.demo", "cli.gligen_inference", "cli.txt2img",
    "data.rl_data", "models.policy", "pipeline.planner", "utils.boxes",
    "utils.flops", "utils.images", "utils.profiling",
)

# the RL trainer, its reward and what they stand on
RL_MODULES = (
    "cli.train_rl", "eval.clip_score", "eval.metrics", "models.clip_vision",
    "pipeline.reward", "training.rl_trainer",
)
# the data loaders and the Pillow-free resize they decode through
DATA_MODULES = (
    "data", "data.catalog", "data.coco", "data.concat", "data.loader",
    "data.modalities", "data.tsv", "utils.resample",
)


def test_every_port_module_imports_without_jax():
    modules = sorted(
        ".".join(("layoutllm_t2i_torch",) + f.relative_to(
            REPO / "layoutllm_t2i_torch").with_suffix("").parts)
        .removesuffix(".__init__")
        for f in (REPO / "layoutllm_t2i_torch").rglob("*.py"))
    assert {f"layoutllm_t2i_torch.{m}" for m in TRAINING_MODULES} <= set(modules)
    assert {f"layoutllm_t2i_torch.{m}" for m in SERVING_MODULES} <= set(modules)
    assert {f"layoutllm_t2i_torch.{m}" for m in GENERATION_MODULES} <= set(modules)
    assert {f"layoutllm_t2i_torch.{m}" for m in RL_MODULES} <= set(modules)
    assert {f"layoutllm_t2i_torch.{m}" for m in DATA_MODULES} <= set(modules)
    # a None entry in sys.modules makes any import of these names raise
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'layoutllm_t2i_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_generation_entry_points_need_no_pillow(tmp_path):
    """The card's machine has no Pillow: the bench and the CLIs run, draw
    their boxes and write their PNGs in a process where importing PIL (and
    JAX) fails."""
    code = ("import sys\n"
            "for name in ('PIL', 'jax', 'jaxlib', 'flax', 'layoutllm_t2i_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from layoutllm_t2i_torch.cli import bench, gligen_inference, txt2img\n"
            "from layoutllm_t2i_torch.utils.images import save_image_grid\n"
            "import numpy as np\n"
            f"out = {str(tmp_path)!r}\n"
            "txt2img.main(['--prompt', 'a dog', '--small', '--device', 'cpu',\n"
            "              '--layout', 'dog:[0.1,0.2,0.5,0.6]', '--sample_steps', '2',\n"
            "              '--num_per_prompt', '1', '--folder', out + '/t'])\n"
            "gligen_inference.main(['--prompt', 'a dog', '--small', '--device', 'cpu',\n"
            "                       '--layout', 'dog:[0.1,0.2,0.5,0.6]', '--folder',\n"
            "                       out + '/g'])\n"
            "save_image_grid(np.zeros((2, 4, 4, 3)), out + '/grid.png', ['a', 'b'])\n"
            "bench.main(['--small', '--device', 'cpu', '--batch', '1', '--iters', '1',\n"
            "            '--steps', '2', '--no_fast'])\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "t" / "a dog_0.png").exists()
    assert (tmp_path / "g" / "sample_0.png").exists()
    assert (tmp_path / "grid.png").exists() and (tmp_path / "grid.txt").exists()
    assert '"metric": "images_per_sec_per_chip"' in proc.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        random_models(small=True)
    bundle = random_models(small=True, device="cpu")
    fields = {f.name: getattr(bundle, f.name) for f in dataclasses.fields(bundle)
              if f.name not in ("device", "compute_dtype")}
    with pytest.raises(RuntimeError, match="CUDA"):
        GligenModels(**fields)
    assert GligenModels(**fields, device="cpu").compute_dtype == torch.float32
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    K.reset_launches()
    x = torch.randn(4, 16)
    w, b = torch.ones(16), torch.zeros(16)
    assert not use_kernel(x)
    torch.testing.assert_close(K.layer_norm(x, w, b), K.layer_norm_plain(x, w, b, 1e-5))
    K.group_norm(torch.randn(1, 4, 32), torch.ones(32), torch.zeros(32), 8)
    q = torch.randn(1, 8, 16)
    K.flash_attention(q, q, q, 2, 0.25)
    w1, w2 = torch.randn(64, 16), torch.randn(16, 32)
    K.ffn_geglu(x, w1, torch.zeros(64), w2, b, x)
    K.ffn_ln_geglu_q(x, w, b, w1.to(torch.int8), torch.ones(64), torch.zeros(64),
                     w2.to(torch.int8), torch.ones(16), b, 0.5)
    K.linear_fused(x, w2.t().contiguous(), None, torch.randn(4, 32))
    K.geglu_fused(x, w1)
    assert K.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                 "K5a": 0, "K5b": 0, "K6": 0, "K7": 0,
                                 "K8a": 0, "K8b": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        use_kernel(torch.empty(1, device="meta"))
