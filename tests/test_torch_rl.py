"""The RL path of the port against the JAX package, on the CPU.

* ``RLTrainer`` against the JAX trainer over 2 epochs of 2 batches (one
  with a dropped row, so padded), with the same stub rollouts (NumPy
  images from the rollout seed), stub LLM and stub reward: the same shots
  reach the LLM and the same rollout seeds the generator, in order; the
  rewards, losses, learning rates and final policy within 1e-5; the
  history and checkpoint files of both.
* Checkpoints across packages: each package's ``ckpt_E.pt`` and
  ``state_E.pt`` load in the other, with the same keys; a directory the
  JAX trainer wrote at epoch 0 resumes in the port to the params the JAX
  resume reaches after epoch 1; a directory holding only a JAX
  ``state_E.pkl`` raises.
* ``cli/train_rl.py --small --device cpu`` runs one epoch on a fixture
  (train/candidate JSONs, a layout cache, 512² PNGs written by
  utils/images.py) with Pillow blocked, and writes its files.
* ``utils/images.py read_png`` reads what ``png_bytes`` writes;
  ``data/rl_data.py`` reads the fixture as the JAX loader does.
* txt2img's policy features with ``--clip_ckpt`` (a bf16 pipeline) come out
  f32 and equal the JAX CLI's.
* The opt-in K8a/K8b route takes f32 operands to the kernels' f32 entries
  (``llt2i_linear_f32``, ``llt2i_geglu_f32``), no longer refused.
"""
import json
import os
import pickle
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from layoutllm_t2i_tpu.checkpoint import convert as jconvert
from layoutllm_t2i_tpu.checkpoint import export as jexport
from layoutllm_t2i_tpu.cli import txt2img as jtxt2img
from layoutllm_t2i_tpu.data import rl_data as jrl_data
from layoutllm_t2i_tpu.models import clip_text as jclip
from layoutllm_t2i_tpu.models import initializers as jinit
from layoutllm_t2i_tpu.models import policy as jpolicy
from layoutllm_t2i_tpu.models.clip_tokenizer import default_tokenizer as jtok
from layoutllm_t2i_tpu.training import rl_trainer as jrl

from layoutllm_t2i_torch.checkpoint import convert as pconvert
from layoutllm_t2i_torch.checkpoint import export as pexport
from layoutllm_t2i_torch.checkpoint.from_jax import state_dict_from_jax
from layoutllm_t2i_torch.cli import train_rl as ptrain_rl
from layoutllm_t2i_torch.cli import txt2img as ptxt2img
from layoutllm_t2i_torch.data import rl_data as prl_data
from layoutllm_t2i_torch.kernels import matmul
from layoutllm_t2i_torch.models.clip_tokenizer import default_tokenizer as ptok
from layoutllm_t2i_torch.training import rl_trainer as prl
from layoutllm_t2i_torch.utils import images as pimages
from torch_kernel_stub import stub_kernels
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

IN_DIM, EMB = 48, 16
LABELS = ["dog", "cat", "car", "kite", "person", "bowl"]


def _examples(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 3))
        out.append({"img_id": i, "name": f"img_{seed}_{i}.png", "width": 512,
                    "height": 512,
                    "bbox": np.round(rng.uniform(0.2, 0.5, (k, 4)), 3).tolist(),
                    "label": [LABELS[j] for j in rng.integers(0, 6, k)],
                    "captions": f"caption {seed}-{i} with {LABELS[i % 6]}"})
    return out


TRAIN, CANDS = _examples(8, 1), _examples(6, 2)


class StubLLM:
    """A layout from the prompt's length (so from the shots it carries);
    nothing for a query whose caption holds "3" (a dropped row)."""

    def __init__(self):
        self.prompts = []

    def __call__(self, prompt):
        self.prompts.append(prompt)
        query = prompt.rsplit("input: ", 1)[-1]
        if "-3 " in query:
            return ""
        n = len(prompt)
        return (f"output:\ndog: [0.{n % 7 + 1}, 0.2, 0.3, 0.4]\n"
                f"kite: [0.5, 0.{n % 5 + 1}, 0.2, 0.2]")


class StubGenerate:
    """Images from the rollout seed, recording the seeds and layouts."""

    def __init__(self):
        self.seeds = []

    def __call__(self, captions, layouts, seed=None):
        self.seeds.append(seed)
        rng = np.random.default_rng(seed)
        return rng.uniform(size=(len(captions), 8, 8, 3)).astype(np.float32)


def stub_reward(captions, imgs_pred, imgs_gt, layouts_pred, layouts_gt):
    box_sum = np.array([np.sum(b) for b, _ in layouts_pred])
    return (imgs_pred.mean(axis=(1, 2, 3)) * 5 - imgs_gt.mean(axis=(1, 2, 3))
            + 0.3 * box_sum)


def _batches():
    gt = np.random.default_rng(4).uniform(size=(8, 8, 8, 3)).astype(np.float32)
    return [(TRAIN[i:i + 4], gt[i:i + 4], list(range(i, i + 4)))
            for i in (0, 4)]


def _feats():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((8, IN_DIM)).astype(np.float32),
            rng.standard_normal((6, IN_DIM)).astype(np.float32))


def _jax_policy():
    return jpolicy.init_policy_params(jax.random.PRNGKey(2), IN_DIM, EMB)


def _torch_policy(jtree):
    return {"linear": {"weight": torch.from_numpy(np.asarray(jtree["linear"]["weight"]).T.copy()),
                       "bias": torch.from_numpy(np.asarray(jtree["linear"]["bias"]))}}


def _config(cls, path, **kw):
    return cls(epochs=kw.pop("epochs", 2), batch_size=4, shot_number=2,
               lr=0.05, lr_step_size=1, lr_gamma=0.5, in_dim=IN_DIM,
               embedding_size=EMB, seed=53, ckpt_path=str(path), **kw)


def _run(pkg, path, **kw):
    """(trainer, history, LLM, generator) of one package's run."""
    llm, gen = StubLLM(), StubGenerate()
    ft, fc = _feats()
    if pkg == "jax":
        trainer = jrl.RLTrainer(_config(jrl.RLConfig, path, **kw), stub_reward,
                                gen, llm, TRAIN, CANDS, ft, fc, _batches(),
                                policy_params=_jax_policy())
    else:
        trainer = prl.RLTrainer(_config(prl.RLConfig, path, **kw), stub_reward,
                                gen, llm, TRAIN, CANDS, ft, fc, _batches(),
                                policy_params=_torch_policy(_jax_policy()),
                                device="cpu")
    history = trainer.train()
    if pkg == "torch":
        trainer.close()
    return trainer, history, llm, gen


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _params(trainer):
    lin = trainer.params["linear"]
    if isinstance(lin["weight"], torch.Tensor):
        return (lin["weight"].detach().numpy().T, lin["bias"].detach().numpy())
    return np.asarray(lin["weight"]), np.asarray(lin["bias"])


def test_trainer_matches_jax(tmp_path):
    jt, jh, jllm, jgen = _run("jax", tmp_path / "jax")
    pt, ph, pllm, pgen = _run("torch", tmp_path / "torch")
    # the same shots and rollout seeds, in the same order
    assert len(pllm.prompts) == 16 and pllm.prompts == jllm.prompts
    assert len(pgen.seeds) == 4 and pgen.seeds == jgen.seeds
    for key in jh:
        assert len(ph[key]) == len(jh[key]), key
        np.testing.assert_allclose(ph[key], jh[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    jm, pm = _metrics(tmp_path / "jax"), _metrics(tmp_path / "torch")
    np.testing.assert_allclose([r["lr"] for r in pm], [r["lr"] for r in jm],
                               rtol=1e-7)
    assert [r["lr"] for r in pm] == [0.05, 0.05, 0.025, 0.025]
    for got, want in zip(_params(pt), _params(jt)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the policy moved, and optax's and torch's Adam counted the same steps
    assert not np.allclose(_params(pt)[0], np.asarray(_jax_policy()["linear"]["weight"]))
    assert pt.adam_state()["step"] == 4
    assert jconvert.load_policy_state(str(tmp_path / "torch" / "state_1.pt"))["step"] == 4
    names = {"ckpt_0.pt", "ckpt_1.pt", "state_0.pt", "state_1.pt", "ckpt_0.pkl",
             "ckpt_1.pkl", "ckpt_final.pt", "ckpt_final.pkl", "history.json",
             "ckpt_best_reward.pt", "ckpt_best_loss.pt", "metrics.jsonl",
             "log.txt"}
    assert names <= set(os.listdir(tmp_path / "torch"))
    with open(tmp_path / "torch" / "history.json") as f:
        assert json.load(f) == ph
    # the .pkl is the JAX package's policy tree
    with open(tmp_path / "torch" / "ckpt_final.pkl", "rb") as f:
        tree = pickle.load(f)
    np.testing.assert_array_equal(tree["linear"]["weight"], _params(pt)[0])
    assert tree["linear"]["weight"].shape == (IN_DIM, EMB)


def test_nan_loss_stops_training(tmp_path):
    nan_reward = lambda *a: np.full(4, np.nan, np.float32)
    ft, fc = _feats()
    trainer = prl.RLTrainer(_config(prl.RLConfig, tmp_path, epochs=3),
                            nan_reward, StubGenerate(), StubLLM(), TRAIN,
                            CANDS, ft, fc, _batches(),
                            policy_params=_torch_policy(_jax_policy()),
                            device="cpu")
    history = trainer.train()
    trainer.close()
    assert len(history["loss_history"]) == 1 and np.isnan(history["loss_history"][0])
    assert len(history["total_loss_history"]) == 1


def _assert_same_keys(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same_keys(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_keys(x, y)
    else:
        assert type(a) is type(b)


def test_checkpoints_load_across_packages(tmp_path):
    jt, _, _, _ = _run("jax", tmp_path / "jax", epochs=1)
    pt, _, _, _ = _run("torch", tmp_path / "torch", epochs=1)
    for src, load, lin in (("jax", pconvert.load_policy, True),
                           ("torch", jconvert.load_policy, False)):
        got = load(str(tmp_path / src / "ckpt_0.pt"))["linear"]
        want = _params(jt if src == "jax" else pt)
        w = got["weight"].numpy().T if lin else got["weight"]
        b = got["bias"].numpy() if lin else got["bias"]
        np.testing.assert_array_equal(w, want[0])
        np.testing.assert_array_equal(b, want[1])
    jstate = torch.load(tmp_path / "jax" / "state_0.pt")
    pstate = torch.load(tmp_path / "torch" / "state_0.pt")
    _assert_same_keys(pstate, jstate)
    for load in (pconvert.load_policy_state, jconvert.load_policy_state):
        a = load(str(tmp_path / "jax" / "state_0.pt"))
        b = load(str(tmp_path / "torch" / "state_0.pt"))
        assert a["step"] == b["step"] == 2
        assert a["last_epoch"] == b["last_epoch"] == 0
        # two trainers' moments: their gradients differ by f32 summation
        # order (~6e-6 relative here; nu, a square, twice that), so held to
        # 1e-4 of each moment's largest value
        for m in ("mu", "nu"):
            for name in ("weight", "bias"):
                ma, mb = (np.asarray(a[m]["linear"][name]),
                          np.asarray(b[m]["linear"][name]))
                np.testing.assert_allclose(ma, mb, rtol=0,
                                           atol=1e-4 * np.abs(mb).max())
    # the port's export of the JAX trainer's Adam state writes the JAX
    # export's file
    st = pconvert.load_policy_state(str(tmp_path / "jax" / "state_0.pt"))
    pexport.export_policy_state(str(tmp_path / "again.pt"), st, epoch=0,
                                lr=0.05, lr_step_size=1, lr_gamma=0.5)
    again = torch.load(tmp_path / "again.pt")
    _assert_same_keys(again, jstate)
    for i in (0, 1):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(again["optimizer"]["state"][i][key],
                                       jstate["optimizer"]["state"][i][key],
                                       rtol=0, atol=0)
    assert again["optimizer"]["param_groups"] == jstate["optimizer"]["param_groups"]
    assert again["lr_scheduler"] == jstate["lr_scheduler"]


def test_port_resumes_a_jax_run(tmp_path):
    _run("jax", tmp_path / "run", epochs=1)
    jt, jh, _, _ = _run("jax", tmp_path / "jax_resumed", epochs=1,
                        resume=str(tmp_path / "run"))
    pt, ph, _, _ = _run("torch", tmp_path / "torch_resumed", epochs=1,
                        resume=str(tmp_path / "run"))
    assert pt.start_epoch == jt.start_epoch == 1
    np.testing.assert_allclose(ph["loss_history"], jh["loss_history"],
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(_params(pt), _params(jt)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert pt.adam_state()["step"] == 4
    assert [r["lr"] for r in _metrics(tmp_path / "torch_resumed")] == [0.025] * 2


def test_resume_from_only_a_pkl_state_raises(tmp_path):
    _run("jax", tmp_path / "run", epochs=1)
    for fn in os.listdir(tmp_path / "run"):
        if fn.startswith("state_") and fn.endswith(".pt"):
            os.remove(tmp_path / "run" / fn)
    with pytest.raises(FileNotFoundError, match="optax"):
        _run("torch", tmp_path / "torch", epochs=1, resume=str(tmp_path / "run"))


# ---------------------------------------------------------------------------
# the CLI, the data reader and the PNG reader


def _fixture(root, n_train=2, n_cand=2):
    data, imgs = root / "data", root / "imgs"
    data.mkdir()
    imgs.mkdir()
    train, cand = _examples(n_train, 1), _examples(n_cand, 2)
    for name, examples, n in (("train", train, n_train),
                              ("candidate", cand, n_cand)):
        (data / f"train2014_{name}_{n}.json").write_text(json.dumps(
            {"id": [e["img_id"] for e in examples], "data": examples}))
    rng = np.random.default_rng(9)
    for e in train:
        (imgs / e["name"]).write_bytes(pimages.png_bytes(
            rng.uniform(size=(512, 512, 3))))
    cache = {e["captions"]: [["dog", [0.1, 0.2, 0.3, 0.4]],
                             ["person", [0.5, 0.3, 0.2, 0.5]]] for e in train}
    (root / "cache.json").write_text(json.dumps(cache))
    return train, str(data), str(imgs), str(root / "cache.json")


def test_read_png_round_trips():
    arr = np.random.default_rng(3).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pimages.read_png(pimages.png_bytes_uint8(arr)), arr)
    f = arr.astype(np.float32) / 255.0
    np.testing.assert_array_equal(pimages.read_png(pimages.png_bytes(f)),
                                  (np.clip(f, 0, 1) * 255).astype(np.uint8))
    png = bytearray(pimages.png_bytes_uint8(arr))
    png[40] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        pimages.read_png(bytes(png))


def test_read_png_refuses_other_forms_and_load_image_takes_pillow(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(4).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "pil.png")  # Pillow filters its rows
    with pytest.raises(pimages.PNGFormatError, match="filter"):
        pimages.read_png((tmp_path / "pil.png").read_bytes())
    Image.fromarray(arr[:300]).save(tmp_path / "small.jpg")
    for name in ("pil.png", "small.jpg"):
        np.testing.assert_array_equal(prl_data.load_image(str(tmp_path), name),
                                      jrl_data.load_image(str(tmp_path), name))


def test_rl_data_reads_what_jax_reads(tmp_path, monkeypatch):
    train, data, imgs, _ = _fixture(tmp_path)
    assert prl_data.load_rl_data(data, 2, 2) == jrl_data.load_rl_data(data, 2, 2)
    want = [(c, np.asarray(g), i) for c, g, i in jrl_data.RLBatches(train, imgs, 2)]
    monkeypatch.setitem(sys.modules, "PIL", None)  # the port needs no Pillow
    got = list(prl_data.RLBatches(train, imgs, 2))
    assert len(got) == len(want) == 1
    assert got[0][0] == want[0][0] and got[0][2] == want[0][2]
    np.testing.assert_array_equal(got[0][1], want[0][1])
    with pytest.raises(RuntimeError, match="Pillow"):
        prl_data.load_image(str(tmp_path), "missing.jpg")


def test_train_rl_cli_on_the_cpu(tmp_path, monkeypatch):
    _, data, imgs, cache = _fixture(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    ckpt_path, history = ptrain_rl.main([
        "--small", "--device", "cpu", "--img_dir", imgs,
        "--sampled_data_dir", data, "--train_number", "2", "--cand_number", "2",
        "--batch_size", "2", "--epochs", "1", "--steps", "3",
        "--layout_cache", cache, "--ckpt_root", str(tmp_path / "ckpt")])
    files = set(os.listdir(ckpt_path))
    assert {"ckpt_0.pt", "state_0.pt", "ckpt_0.pkl", "history.json",
            "ckpt_final.pt", "log.txt", "metrics.jsonl"} <= files
    assert len(history["loss_history"]) == 1
    assert np.isfinite(history["loss_history"]).all()
    assert np.isfinite(history["reward_history"]).all()
    assert pconvert.load_policy_state(os.path.join(ckpt_path, "state_0.pt"))["step"] == 1
    assert ptrain_rl.parse_args(["--img_dir", "x"]).device is None
    jflags = set(vars(__import__("layoutllm_t2i_tpu.cli.train_rl", fromlist=["x"])
                      .parse_args(["--img_dir", "x"])))
    assert set(vars(ptrain_rl.parse_args(["--img_dir", "x"]))) == jflags | {"device"}


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ft, fc = _feats()
    with pytest.raises(RuntimeError, match="CUDA"):
        prl.RLTrainer(_config(prl.RLConfig, tmp_path), stub_reward,
                      StubGenerate(), StubLLM(), TRAIN, CANDS, ft, fc, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrain_rl.main(["--small", "--img_dir", str(tmp_path),
                        "--ckpt_root", str(tmp_path)])


# ---------------------------------------------------------------------------
# txt2img's policy features with --clip_ckpt: f32 on a bf16 pipeline


TINY_CLIP = dict(num_layers=2, hidden_size=128, num_heads=2,
                 intermediate_size=256)


def test_txt2img_clip_features_are_f32(tmp_path, monkeypatch):
    cfg = jclip.CLIPTextConfig(**TINY_CLIP)
    params = jclip.init_clip_text_params(jax.random.PRNGKey(5), cfg)
    params["text_projection"] = jinit.linear_p(jax.random.PRNGKey(6), 128, 768,
                                               bias=False)
    sd = {(n if n.startswith("text_projection") else "text_model." + n): t
          for n, t in state_dict_from_jax(params).items()}
    torch.save(sd, tmp_path / "clip.pth")
    texts = ["a dog chasing a ball", "a cat under a table", "two kites"]
    args = SimpleNamespace(clip_ckpt=str(tmp_path / "clip.pth"))
    # the JAX CLI reads the CLIPModel at the full ViT-L config
    monkeypatch.setattr(jclip, "CLIPTextConfig", lambda: cfg)
    monkeypatch.setattr(jtxt2img, "_PIPE",
                        SimpleNamespace(models=SimpleNamespace(tokenizer=jtok())))
    want = np.asarray(jtxt2img._caption_features(texts, args))
    # a pipeline whose compute dtype is bf16, as on the card
    models = SimpleNamespace(device=torch.device("cpu"), tokenizer=ptok(),
                             compute_dtype=torch.bfloat16)
    args._pipe = SimpleNamespace(models=models)
    got = ptxt2img._caption_features(texts, args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the opt-in GEMM route on f32 operands


@pytest.mark.parametrize("fn,args", [
    (matmul.linear_fused, lambda x: (x, torch.zeros(128, 256))),
    (matmul.geglu_fused, lambda x: (x, torch.zeros(256, 256)))])
def test_f32_gemm_route_names_the_roadmap_item(monkeypatch, fn, args):
    """The item this test once named (ROADMAP Queue 2, f32 operands of K8a
    and K8b) is done: an f32 operand on the kernel route reaches the f32 C
    entry and counts as an f32 launch."""
    lib = stub_kernels(monkeypatch)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "f32_launches", 0)
    out = fn(*args(torch.zeros(1024, 256)))
    assert out.dtype is torch.float32
    name = "llt2i_linear_f32" if fn is matmul.linear_fused else "llt2i_geglu_f32"
    assert lib.calls == [name]
    assert fn.launches == fn.f32_launches == 1
    # a bf16 operand still takes the bf16 entry
    fn(*(t.bfloat16() for t in args(torch.zeros(1024, 256))))
    assert lib.calls == [name, name[:-len("_f32")]]
    assert fn.launches == 2 and fn.f32_launches == 1
