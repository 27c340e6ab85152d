"""K2's plan and its arithmetic, on the CPU.

``plan_group_norm`` is a function of the shape alone: it is held here at
every K2 shape that chip_smoke.py's walk gives (the generation on its three
routes and a batch-8 training step) and at the card tests' shapes. The CUDA
kernels run only on the card, so their arithmetic is emulated here in torch,
in the plan's partition and merge order: per-block per-channel sums shifted
by the block's first row, Chan's merge of channels into groups within a
block and of blocks across the cluster (or of statistics chunks, on the
streaming path), gamma and beta folded into a per-channel scale and shift,
bf16 output. The emulation must hold K2's card tolerance against the plain
version (``agreement("K2", ...)``) and, in f32, the JAX package's Pallas
GroupNorm in interpret mode to 2e-5 (f32 on both sides, differing in
summation order only), and four planted faults of the design must fail.
"""
import importlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.norms import _gn_pallas, _gn_pallas_rows
from layoutllm_t2i_torch.kernels.tolerance import agreement
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()
# the module (the package exports the wrapper function under its name)
gn = importlib.import_module("layoutllm_t2i_torch.kernels.group_norm")


def _walked_shapes():
    """{(N, HW, C): paths} of every K2 call of chip_smoke's walk, and the
    UNet's K2 shapes at batch 4, 8 and 16 (the bench's CFG batch)."""
    from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    tok = clip_cfg.max_length
    batch = next(synthetic_layout_batches(cs.TRAIN_BATCH, 64, cs.TRAIN_MAX_BOXES))
    batch["image"] = np.zeros((cs.TRAIN_BATCH, 512, 512, 3), np.float32)
    paths = {name: cs.generation_calls(unet_cfg, vae_cfg, clip_cfg, tok,
                                       cs.REQUESTS, cs.VAE_CHUNK, route=route)
             for name, route in (("generate", cs.DEFAULT), ("int8", cs.INT8),
                                 ("routes", cs.SPLIT))}
    paths["train"] = cs.training_calls(unet_cfg, vae_cfg, clip_cfg, tok, batch,
                                       cs.TRAIN_MAX_BOXES,
                                       cs.TRAIN_MAX_RELATIONS)
    for name, pipe in zip(("bench", "bench-fast"),
                          cs.bench_pipelines(cs.tables_models())):
        paths[name] = cs.generation_calls(
            unet_cfg, vae_cfg, clip_cfg, tok, cs.bench_requests(), cs.VAE_CHUNK,
            evals=cs.unet_evaluations(pipe, cs.BENCH_BATCH))
    shapes = {}
    for kid, _, args, where in cs.kernel_cases(paths):
        if kid == "K2":
            shapes.setdefault(args[:3], set()).update(where)
    unet = {args[:3] for b in (4, 8, 16)
            for kid, args in cs.unet_calls(unet_cfg, b, 30, 5, tok)
            if kid == "K2"}
    return shapes, unet


WALKED, UNET_SHAPES = _walked_shapes()
# tests/test_torch_cuda.py's shapes (N, HW, C, G)
CARD_SHAPES = [(3, 49, 96, 32), (1, 4096, 64, 32), (2, 1, 2560, 32),
               (1, 16384, 128, 8), (2, 4097, 96, 32),
               (2, 4096, 320, 32), (2, 65536, 256, 32)]
# a 16-channel slab that only a cluster of 10 blocks would hold: it streams
OVER_CLUSTER = (1, 65536, 32, 2)
PLANNED = sorted((*s, 32) for s in WALKED) + CARD_SHAPES + [OVER_CLUSTER]


def _spans(hw, rows, count):
    return [(k * rows, min(hw, (k + 1) * rows)) for k in range(count)]


def _covers_once(hw, spans):
    """The spans are non-empty and tile [0, hw) in order, each row once."""
    return (all(a < b for a, b in spans) and spans[0][0] == 0
            and spans[-1][1] == hw
            and all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1)))


@pytest.mark.parametrize("n,hw,c,groups", PLANNED,
                         ids=[f"N{n}-HW{hw}-C{c}-G{g}" for n, hw, c, g in PLANNED])
def test_plan(n, hw, c, groups):
    plan = gn.plan_group_norm(n, hw, c, groups)
    cg = c // groups
    assert plan.slab % cg == 0 and plan.slab % 8 == 0 and c % plan.slab == 0
    if plan.path == "cluster":
        # a portable cluster: 8 blocks at most
        assert 1 <= plan.cluster <= gn.MAX_CLUSTER == 8
        assert _covers_once(hw, _spans(hw, plan.rows, plan.cluster))
        assert gn.cluster_smem_bytes(plan.rows, plan.slab, cg) <= gn.SMEM_MAX
    else:
        assert plan.path == "stream"
        assert _covers_once(hw, _spans(hw, plan.rows, plan.chunks))
        blocks = -(-hw // plan.apply_rows)
        assert _covers_once(hw, _spans(hw, plan.apply_rows, blocks))
        # no portable cluster holds the on-chip slab
        rows = -(-hw // gn.MAX_CLUSTER)
        assert gn.cluster_smem_bytes(rows, gn.cluster_slab(c, groups), cg) > gn.SMEM_MAX
    if (n, hw, c) in UNET_SHAPES:
        assert plan.path == "cluster", "every UNet shape stays on chip"


def test_walk_reaches_both_paths():
    """The walk has the UNet's shapes at batch 4, 8 and 16 (18 distinct in
    one evaluation) and the VAE's 512^2 levels, which stream."""
    paths = {gn.plan_group_norm(*s, 32).path for s in WALKED}
    assert paths == {"cluster", "stream"}
    assert UNET_SHAPES <= set(WALKED)
    assert {s[0] for s in UNET_SHAPES} == {4, 8, 16}
    assert gn.plan_group_norm(2, 262144, 256, 32).path == "stream"
    assert gn.plan_group_norm(*OVER_CLUSTER).path == "stream"


@pytest.mark.parametrize("shape", [(2, 8, 12, 32), (2, 8, 12, 30), (1, 8, 8, 129)])
def test_plan_refuses_what_the_kernel_refuses(shape):
    # C % 8, C % G and G > 128 raise, as before the redesign
    n, hw, c, groups = shape
    with pytest.raises(ValueError, match="unsupported"):
        gn.plan_group_norm(n, hw, c, groups)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated


def emulate(x, gamma, beta, groups, eps, silu, plan, fault=None):
    """K2 along ``plan`` in f32 torch: blocks (on chip) or statistics chunks
    (streaming) of ``plan.rows`` rows over slabs of ``plan.slab`` channels,
    each block's sums shifted by its first row, merged as csrc/group_norm.cu
    merges them. Returns f32 (round to bf16 for the kernel's output).
    ``fault`` plants one of: "own_stats" (a block normalises with its own
    statistics), "drop_ragged" (the last block's rows are dropped),
    "slab_off" (slab boundaries one channel off the group boundaries),
    "gamma_neighbour" (gamma and beta read from the next slab)."""
    n, hw, c = x.shape
    cg = c // groups
    s = plan.slab
    xf = x.float()
    gf, bf = gamma.float(), beta.float()
    if fault == "slab_off":
        xf, gf, bf = xf.roll(-1, 2), gf.roll(-1), bf.roll(-1)
    if fault == "gamma_neighbour":
        gf, bf = gf.roll(-s), bf.roll(-s)
    nslab, gs = c // s, s // cg
    xs = xf.view(n, hw, nslab, s)
    spans = _spans(hw, plan.rows, -(-hw // plan.rows))
    if fault == "drop_ragged":
        assert spans[-1][1] - spans[-1][0] < plan.rows
        spans = spans[:-1]
    parts = []  # per block: (count, mean, M2) each (n, nslab, gs)
    for r0, r1 in spans:
        t = xs[:, r0:r1]
        nr = r1 - r0
        d = t - t[:, :1]
        s1, s2 = d.sum(1), (d * d).sum(1)               # (n, nslab, s)
        m = s1 / nr
        cmean = (t[:, 0] + m).view(n, nslab, gs, cg)
        cm2 = (s2 - s1 * m).clamp_min(0).view(n, nslab, gs, cg)
        gmean = cmean.sum(-1) / cg
        gm2 = (cm2 + nr * (cmean - gmean[..., None]) ** 2).sum(-1)
        parts.append((torch.full_like(gmean, float(nr * cg)), gmean, gm2))
    cnt = torch.stack([p[0] for p in parts])
    mk = torch.stack([p[1] for p in parts])
    m2k = torch.stack([p[2] for p in parts])
    tot = cnt.sum(0)
    mean = (cnt * mk).sum(0) / tot
    m2 = (m2k + cnt * (mk - mean) ** 2).sum(0)
    rstd = torch.rsqrt(m2 / tot + eps)
    y = torch.zeros_like(xs)
    for k, (r0, r1) in enumerate(spans):
        if fault == "own_stats":
            mean_b, rstd_b = mk[k], torch.rsqrt(m2k[k] / cnt[k] + eps)
        else:
            mean_b, rstd_b = mean, rstd
        mean_c = mean_b.repeat_interleave(cg, -1)        # (n, nslab, s)
        rstd_c = rstd_b.repeat_interleave(cg, -1)
        sc = gf.view(nslab, s) * rstd_c
        sh = bf.view(nslab, s) - mean_c * sc
        t = xs[:, r0:r1] * sc[:, None] + sh[:, None]
        y[:, r0:r1] = t / (1 + torch.exp(-t)) if silu else t
    y = y.view(n, hw, c)
    return y.roll(1, 2) if fault == "slab_off" else y


def _inputs(n, hw, c, groups, seed, dtype=np.float32):
    """x with a ramp along the rows and an offset per group, so that blocks,
    groups and slabs see different statistics; gamma and beta that vary."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(-2.0, 3.0, hw, dtype=np.float32)[None, :, None]
    offset = np.repeat(rng.normal(0, 3, groups).astype(np.float32), c // groups)
    x = rng.standard_normal((n, hw, c)).astype(np.float32) * 1.5 + ramp + offset
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    return x, gamma, beta


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _forced(kind, n, hw, c, groups):
    """The planner's on-chip plan, or the streaming plan, of a shape."""
    if kind == "stream":
        return gn.stream_plan(n, hw, c, groups)
    plan = gn.plan_group_norm(n, hw, c, groups)
    assert plan.path == "cluster"
    return plan


EMULATED = [("cluster", (2, 4097, 96, 32)),   # C/G = 3, ragged last block
            ("cluster", (3, 49, 96, 32)),
            ("cluster", (2, 1030, 640, 32)),  # the UNet's 40-channel slabs
            ("stream", (2, 3001, 128, 32)),
            ("stream", (1, 777, 2560, 32))]   # two statistics slabs


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("kind,shape", EMULATED,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in EMULATED])
def test_emulation_agrees_with_plain(kind, shape, silu):
    n, hw, c, groups = shape
    plan = _forced(kind, *shape)
    x, gamma, beta = (_bf16(a) for a in _inputs(n, hw, c, groups, 0))
    out = emulate(x, gamma, beta, groups, 1e-6, silu, plan).to(torch.bfloat16)
    ref = gn.group_norm_plain(x, gamma, beta, groups, 1e-6, silu)
    got = agreement("K2", out, ref)
    assert got["ok"], got


@pytest.mark.parametrize("kind", ["cluster", "stream"])
@pytest.mark.parametrize("silu", [False, True])
def test_emulation_matches_pallas(kind, silu):
    # f32 inputs through the JAX package's on-chip and row-streaming Pallas
    # GroupNorm (interpret mode) and the emulation of either path
    n, h, w, c = 2, 16, 16, 128
    x, gamma, beta = _inputs(n, h * w, c, 32, 1)
    xj = jnp.asarray(x.reshape(n, h, w, c))
    args = (jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5, silu)
    if kind == "cluster":
        ref = _gn_pallas(xj, *args, interpret=True, k=1)
    else:
        ref = _gn_pallas_rows(xj, *args, interpret=True, rb=64)
    plan = _forced(kind, n, h * w, c, 32)
    if kind == "cluster":
        assert plan.cluster > 1
    out = emulate(torch.from_numpy(x), torch.from_numpy(gamma),
                  torch.from_numpy(beta), 32, 1e-5, silu, plan)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(n, h * w, c),
                               atol=2e-5)


@pytest.mark.parametrize("fault", ["own_stats", "drop_ragged", "slab_off",
                                   "gamma_neighbour"])
def test_planted_faults_fail(fault):
    n, hw, c, groups = 2, 4097, 96, 32
    plan = _forced("cluster", n, hw, c, groups)
    assert plan.cluster > 1 and hw % plan.rows and c // plan.slab > 1
    x, gamma, beta = (_bf16(a) for a in _inputs(n, hw, c, groups, 2))
    ref = gn.group_norm_plain(x, gamma, beta, groups, 1e-6, True)
    ok = emulate(x, gamma, beta, groups, 1e-6, True, plan)
    assert agreement("K2", ok.to(torch.bfloat16), ref)["ok"]
    bad = emulate(x, gamma, beta, groups, 1e-6, True, plan, fault)
    got = agreement("K2", bad.to(torch.bfloat16), ref)
    assert not got["ok"], got


# ---------------------------------------------------------------------------
# the f32 form: the same kernels on f32 values (csrc Chan8<float>)


@pytest.mark.parametrize("n,hw,c,groups", PLANNED,
                         ids=[f"N{n}-HW{hw}-C{c}-G{g}" for n, hw, c, g in PLANNED])
def test_plan_f32(n, hw, c, groups):
    # at item size 4 the tile holds half the rows: the plan's blocks fit
    # shared memory at 4 bytes a value, and a shape that streams in bf16
    # streams in f32
    plan = gn.plan_group_norm(n, hw, c, groups, 4)
    cg = c // groups
    assert plan.slab % cg == 0 and plan.slab % 8 == 0 and c % plan.slab == 0
    if plan.path == "cluster":
        assert 1 <= plan.cluster <= gn.MAX_CLUSTER
        assert _covers_once(hw, _spans(hw, plan.rows, plan.cluster))
        assert gn.cluster_smem_bytes(plan.rows, plan.slab, cg, 4) <= gn.SMEM_MAX
    else:
        assert plan == gn.stream_plan(n, hw, c, groups)
        rows = -(-hw // gn.MAX_CLUSTER)
        assert gn.cluster_smem_bytes(rows, gn.cluster_slab(c, groups), cg,
                                     4) > gn.SMEM_MAX
    if gn.plan_group_norm(n, hw, c, groups).path == "stream":
        assert plan.path == "stream"


def test_f32_plan_streams_where_an_f32_slab_does_not_fit():
    # the tile is the only part of the layout that the item size changes
    for rows, slab, cg in ((683, 40, 10), (1366, 16, 16), (1, 8, 1)):
        assert (gn.cluster_smem_bytes(rows, slab, cg, 4)
                - gn.cluster_smem_bytes(rows, slab, cg)
                == gn._round16(4 * rows * slab) - gn._round16(2 * rows * slab))
    # the UNet's 64^2 level at 960 channels, batch 8 (the decoder's
    # 120-channel slabs): on chip in bf16, streamed in f32
    assert gn.plan_group_norm(8, 4096, 960, 32).path == "cluster"
    assert gn.plan_group_norm(8, 4096, 960, 32, 4).path == "stream"
    # the VAE encoder's 512^2 and 256^2 levels at batch 8 stream either way
    for hw, c in ((262144, 128), (65536, 128), (65536, 256)):
        assert gn.plan_group_norm(8, hw, c, 32, 4).path == "stream"
    # more blocks a cluster where an f32 slab needs them
    assert (gn.plan_group_norm(8, 4096, 320, 32, 4).cluster
            > gn.plan_group_norm(8, 4096, 320, 32).cluster)


def _forced_f32(kind, n, hw, c, groups):
    if kind == "stream":
        return gn.stream_plan(n, hw, c, groups)
    plan = gn.plan_group_norm(n, hw, c, groups, 4)
    assert plan.path == "cluster"
    return plan


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("kind,shape", EMULATED,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in EMULATED])
def test_f32_emulation_agrees_with_plain(kind, shape, silu):
    # f32 in and out: the plain version's f32 GroupNorm, held to K2's f32 row
    n, hw, c, groups = shape
    plan = _forced_f32(kind, *shape)
    x, gamma, beta = (torch.from_numpy(a) for a in _inputs(n, hw, c, groups, 0))
    out = emulate(x, gamma, beta, groups, 1e-6, silu, plan)
    ref = gn.group_norm_plain(x, gamma, beta, groups, 1e-6, silu)
    assert ref.dtype is torch.float32
    got = agreement("K2/f32", out, ref)
    assert got["ok"], got


@pytest.mark.parametrize("fault", ["own_stats", "drop_ragged", "slab_off",
                                   "gamma_neighbour"])
def test_f32_planted_faults_fail(fault):
    n, hw, c, groups = 2, 4097, 96, 32
    plan = _forced_f32("cluster", n, hw, c, groups)
    assert plan.cluster > 1 and hw % plan.rows and c // plan.slab > 1
    x, gamma, beta = (torch.from_numpy(a) for a in _inputs(n, hw, c, groups, 2))
    ref = gn.group_norm_plain(x, gamma, beta, groups, 1e-6, True)
    assert agreement("K2/f32", emulate(x, gamma, beta, groups, 1e-6, True,
                                       plan), ref)["ok"]
    bad = emulate(x, gamma, beta, groups, 1e-6, True, plan, fault)
    got = agreement("K2/f32", bad, ref)
    assert not got["ok"], got


def test_shifted_sums_keep_a_large_group_accurate():
    # one group of 2^20 elements with mean 300 and std 1: the shifted sums
    # and Chan's merges keep its variance in f32
    n, hw, c, groups = 1, 65536, 16, 1
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((n, hw, c)) + 300.0).astype(np.float32)
    plan = gn.stream_plan(n, hw, c, groups)
    one = torch.ones(c)
    out = emulate(torch.from_numpy(x), one, 0 * one, groups, 1e-6, False, plan)
    ref = (x - x.astype(np.float64).mean()) / x.astype(np.float64).std()
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)


# ---------------------------------------------------------------------------
# the streaming pair split across ranks ('spatial' tensor parallelism): each
# rank's statistics launch on its rows, every rank's partials gathered
# between the launches, the apply launch merging them all by count


def split_partials(x, groups, plan):
    """(n, G, chunks, 3) partials of one rank's rows in ``plan``'s chunks,
    as gn_stats_kernel writes them: (count, mean, M2), the sums shifted by
    each chunk's first row, channels merged into groups by Chan's formula."""
    n, hw, c = x.shape
    cg = c // groups
    xf = x.float()
    out = []
    for r0, r1 in _spans(hw, plan.rows, plan.chunks):
        t, nr = xf[:, r0:r1], r1 - r0
        d = t - t[:, :1]
        s1, s2 = d.sum(1), (d * d).sum(1)
        m = s1 / nr
        cmean = (t[:, 0] + m).view(n, groups, cg)
        cm2 = (s2 - s1 * m).clamp_min(0).view(n, groups, cg)
        gmean = cmean.sum(-1) / cg
        gm2 = (cm2 + nr * (cmean - gmean[..., None]) ** 2).sum(-1)
        out.append(torch.stack([torch.full_like(gmean, float(nr * cg)), gmean,
                                gm2], dim=-1))
    return torch.stack(out, dim=2)


def per_chunk_merge(part, eps):
    """The planted fault: every chunk weighted alike, not by its count."""
    cnt, mk, m2k = part.unbind(-1)
    mean = mk.mean(-1)
    m2 = (m2k + cnt * (mk - mean[..., None]) ** 2).sum(-1)
    return mean, torch.rsqrt(m2 / cnt.sum(-1) + eps)


def emulate_split(x, gamma, beta, groups, eps, silu, world, fault=None):
    """K2's split pair over ``world`` ranks' blocks of x's rows, merged as
    gn_apply_kernel merges (gn.merge_partials), or per chunk (``fault``).
    Returns f32 rows in order and every rank's plan."""
    n, hw, c = x.shape
    blocks = x.chunk(world, dim=1)
    plans = [gn.stream_plan(n, b.shape[1], c, groups) for b in blocks]
    every = torch.cat([split_partials(b, groups, p)
                       for b, p in zip(blocks, plans)], dim=2)
    merge = per_chunk_merge if fault == "per_chunk" else gn.merge_partials
    mean, rstd = merge(every, eps)
    xf = x.float().view(n, hw, groups, c // groups)
    y = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]).view(n, hw, c)
    y = y * gamma.float() + beta.float()
    return (y * torch.sigmoid(y) if silu else y), plans


SPLIT = [(2, 2, 1501, 128, 32), (3, 2, 1501, 128, 32), (2, 1, 2048, 320, 32)]


def _split_inputs(world, n, hw_r, c, groups, seed):
    """_inputs with the last row of every rank's block lifted by 20: a
    ragged last chunk that a merge by chunk would over-weight."""
    x, gamma, beta = _inputs(n, world * hw_r, c, groups, seed)
    x[:, hw_r - 1::hw_r] += 20.0
    return x, gamma, beta


@pytest.mark.parametrize("world,n,hw_r,c,groups", SPLIT)
def test_split_emulation_agrees_with_the_whole(world, n, hw_r, c, groups):
    x, gamma, beta = (_bf16(a) for a in _split_inputs(world, n, hw_r, c,
                                                      groups, 4))
    out, plans = emulate_split(x, gamma, beta, groups, 1e-6, True, world)
    ref = gn.group_norm_plain(x, gamma, beta, groups, 1e-6, True)
    got = agreement("K2", out.to(torch.bfloat16), ref)
    assert got["ok"], got


def test_split_per_chunk_merge_fails():
    world, n, hw_r, c, groups = SPLIT[0]
    x, gamma, beta = (_bf16(a) for a in _split_inputs(world, n, hw_r, c,
                                                      groups, 4))
    _, plans = emulate_split(x, gamma, beta, groups, 1e-6, True, world)
    assert all(hw_r % p.rows for p in plans)   # a shorter last chunk
    ref = gn.group_norm_plain(x, gamma, beta, groups, 1e-6, True)
    bad, _ = emulate_split(x, gamma, beta, groups, 1e-6, True, world,
                           "per_chunk")
    got = agreement("K2", bad.to(torch.bfloat16), ref)
    assert not got["ok"], got


@pytest.mark.parametrize("world,n,hw_r,c,groups", SPLIT)
def test_split_plain_path_matches_the_whole_f32(world, n, hw_r, c, groups):
    """group_norm_split on CPU tensors (its plain version): each rank's
    output, with every rank's partials handed to it as the gather would,
    equals the whole tensor's plain GroupNorm in f32."""
    x, gamma, beta = (torch.from_numpy(a) for a in _split_inputs(
        world, n, hw_r, c, groups, 5))
    blocks = x.chunk(world, dim=1)
    rows = gn.stream_plan(n, hw_r, c, groups).rows
    every = torch.cat([gn.group_norm_stats_plain(b, groups, rows)
                       for b in blocks], dim=2)
    out = torch.cat([gn.group_norm_split(b, gamma, beta, groups, 1e-5, False,
                                         lambda part: every)
                     for b in blocks], dim=1)
    ref = gn.group_norm_plain(x, gamma, beta, groups, 1e-5, False)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)
