"""K1: non-causal flash-attention forward, and K5a/K5b: its backward
(csrc/flash_attention.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/flash_attention.py``: ``_flash_bh``
and its four forward kernels (K1), and the custom VJP's ``_bwd_dq_kernel``
(K5a) and ``_bwd_dkv_kernel`` (K5b). Operands use the packed-head layout
the projections produce, (B, N, H*d), so no transposed copy is made.

``flash_attention`` is differentiable. Where a gradient is needed it runs
``FlashAttention``, an ``autograd.Function`` whose forward also writes the
row log-sum-exp (the JAX forward's ``need_lse``) and saves q, k, v, the
output and the lse: no N x M matrix. Its backward takes
delta = rowsum(dO * O) as one plain reduction, as the JAX package takes it
in XLA, then K5a (dQ) and K5b (dK, dV) recompute the softmax from the lse.
Where no gradient is needed, K1 launches exactly as for inference.

Each kernel comes in bf16 and in f32 (``llt2i_flash_*_f32``: 3xTF32
products on TF32 wgmma with TMA; P and dS kept in f32, as the Pallas
kernels keep them in the operands' type), picked from q's dtype; q, k, v
and dO share it.

Head dims. The Pallas kernels take any d (they zero-pad it to 128 lanes);
so do these. Each instantiation takes every d up to its width, its tensor
maps zero-filling the columns past d (``K1_WIDTHS``, ``K5_WIDTHS``; the C
entry points pick the smallest width that holds d): K1 every d <= 512,
K5a/K5b every d <= 320, in both types (past 160 K5b runs as two launches
from one wrapper call, a dV pass and a dK pass, one count; K5's f32 forms
there stream the scores' depth, ``flash_bwd_*_f32_stream_kernel``). The
maps' head stride must be whole 16-byte vectors (d % 8 == 0 in bf16,
d % 4 in f32): for any other d (16 heads at 320 channels give d 20; d 300
in bf16 runs at 304) the wrapper launches the kernel on a zero-padded
packed copy of q, k, v (and dO) at the next such d, with the scale of the
true d, and returns the output's first d columns of each head
(``padded_head_dim``; an explicit copy, not a fallback). Past 512 (K1) or
320 (K5) a card call raises naming ROADMAP.md's Queue 2 item (K1 past
512, then K5 past 320): ``num_heads`` 1 at 512^2 reaches K1 at d 640 so.

K1/f32 at widths up to 160 splits K and V (and
transposes V) once a call into a workspace that the wrapper allocates for
the call (``llt2i_flash_fwd_f32_ws`` bytes). K5a/f32 and K5b/f32 read q,
k, v and dO split, and k, q and dO also transposed, from a workspace of
``llt2i_flash_bwd_f32_ws`` bytes that a pre-pass writes: each wrapper
allocates and fills its own, and ``FlashAttention.backward`` fills one in
the K5a call for both kernels (``prepare``), so a training step's backward
splits each operand once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import check, lib
from .dispatch import (needs_grad, operand_dtype, require, stream_handle,
                       use_kernel, vector_elems)

# the widths of the kernels' instantiations (csrc/flash_attention.cu): each
# takes every head dim up to it, its maps zero-filling the columns past d.
# bf16 rounds d up to 16 (wgmma's depth), so d 40 runs the 48-wide one.
K1_WIDTHS = {torch.bfloat16: (48, 64, 80, 128, 160, 512),
             torch.float32: (40, 64, 80, 128, 160, 512)}
K5_WIDTHS = {torch.bfloat16: (48, 64, 80, 128, 160, 256, 320),
             torch.float32: (40, 64, 80, 128, 160, 256, 320)}
# where the head dims past the widest are listed as still to port
NOT_PORTED = "ROADMAP.md Queue 2: K1 past d 512, K5a/K5b past d 320"


def padded_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim a kernel call runs at: d rounded up to whole 16-byte
    vectors of ``dtype`` (8 bf16, 4 f32), the tensor maps' head stride."""
    per_vec = vector_elems(dtype)
    return -(-d // per_vec) * per_vec


def kernel_width(kid: str, dtype: torch.dtype, d: int) -> int:
    """The width of the instantiation of ``kid`` ("K1", "K5a" or "K5b")
    that runs head dim d in ``dtype``: the smallest that holds
    ``padded_head_dim(d)``. Raises ValueError past the widest."""
    dp = padded_head_dim(d, dtype)
    widths = (K1_WIDTHS if kid == "K1" else K5_WIDTHS)[dtype]
    for w in widths:
        if dp <= w:
            return w
    raise ValueError(f"{kid}: head dim {d} is past the widest kernel "
                     f"({widths[-1]}); not ported ({NOT_PORTED})")


def pad_heads(t: torch.Tensor, heads: int, dp: int) -> torch.Tensor:
    """(B, rows, H*d) -> a contiguous zero-padded copy (B, rows, H*dp)."""
    b, n, hc = t.shape
    d = hc // heads
    out = t.new_zeros((b, n, heads, dp))
    out[..., :d] = t.reshape(b, n, heads, d)
    return out.view(b, n, heads * dp)


def unpad_heads(t: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    """(B, rows, H*dp) -> (B, rows, H*d): each head's first d columns."""
    b, n, hc = t.shape
    return t.view(b, n, heads, hc // heads)[..., :d].reshape(b, n, heads * d)


def _padded(kid, dtype, heads, *ts):
    """(d, the head dim the kernel runs at, ``ts`` as it takes them): the
    packed operands' head dim, and zero-padded copies where the two differ.
    Raises past ``kid``'s widest instantiation."""
    d = ts[0].shape[2] // heads
    kernel_width(kid, dtype, d)
    dp = padded_head_dim(d, dtype)
    if dp != d:
        ts = tuple(pad_heads(t, heads, dp) for t in ts)
    return d, dp, ts


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*d) -> (B, H, N, d) f32."""
    b, n, hc = t.shape
    return t.reshape(b, n, heads, hc // heads).transpose(1, 2).float()


def _packed(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, N, d) -> (B, N, H*d) in ``dtype``."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d).to(dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, heads: int, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax(q k^T * scale) v per head, lse (B, H, N) f32), in f32."""
    sim = torch.einsum("bhnc,bhmc->bhnm", _heads(q, heads), _heads(k, heads))
    sim = sim * scale
    lse = torch.logsumexp(sim, dim=-1)
    out = torch.einsum("bhnm,bhmc->bhnc", torch.exp(sim - lse[..., None]),
                       _heads(v, heads))
    return _packed(out, q.dtype), lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head, computed in f32."""
    return flash_attention_lse_plain(q, k, v, heads, scale)[0]


def attention_delta(out: torch.Tensor, dout: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: (B, H, N) f32."""
    b, n, hc = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, n, heads, hc // heads).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor,
                              heads: int, scale: float):
    """(dq, dk, dv) recomputed from the lse, the math of K5a/K5b: S = q k^T
    * scale, P = exp(S - lse), dV = P^T dO, dS = P o (dO V^T - delta),
    dQ = scale dS K, dK = scale dS^T Q; P and dS rounded to the operands'
    dtype before their products, as the kernels round them."""
    qh, kh, vh, doh = (_heads(t, heads) for t in (q, k, v, dout))
    s = torch.einsum("bhnc,bhmc->bhnm", qh, kh) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhnc,bhmc->bhnm", doh, vh)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dv = torch.einsum("bhnm,bhnc->bhmc", p, doh)
    dq = torch.einsum("bhnm,bhmc->bhnc", ds, kh) * scale
    dk = torch.einsum("bhnm,bhnc->bhmc", ds, qh) * scale
    return _packed(dq, q.dtype), _packed(dk, k.dtype), _packed(dv, v.dtype)


# the C entry points of each form: dtype -> (K1, K5a, K5b)
_ENTRY = {torch.bfloat16: ("llt2i_flash_fwd", "llt2i_flash_bwd_dq",
                           "llt2i_flash_bwd_dkv"),
          torch.float32: ("llt2i_flash_fwd_f32", "llt2i_flash_bwd_dq_f32",
                          "llt2i_flash_bwd_dkv_f32")}


def _check_qkv(q, k, v, heads, what):
    """q, k and v of q's operand type (bf16 or f32) on one card, packed
    (B, rows, H*d) with 16-byte aligned rows: strides in whole 16-byte
    vectors of that type (8 bf16, 4 f32). Returns the type."""
    b, _, hc = q.shape
    dev = q.get_device()
    dtype = operand_dtype(q)
    per_vec = vector_elems(dtype)
    name_of = "bf16" if dtype is torch.bfloat16 else "f32"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda and t.get_device() == dev and t.dtype is dtype):
            raise ValueError(f"{what}: {name} must be {name_of} on {q.device}")
        if not (t.dim() == 3 and t.shape[0] == b and t.shape[2] == hc):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)}")
        if (t.stride(2) != 1 or t.stride(1) % per_vec
                or t.stride(0) % per_vec or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} rows must be 16-byte aligned")
    if v.shape[1] != k.shape[1]:
        raise ValueError(f"{what}: k and v lengths differ")
    if hc % heads:
        raise ValueError(f"{what}: {hc} columns do not split into {heads} heads")
    return dtype


def _launch_fwd(q, k, v, heads, scale, need_lse):
    """K1; with ``need_lse`` it also writes the (B, H, N) f32 lse. A head
    dim that is not whole 16-byte vectors runs on padded copies."""
    dtype = _check_qkv(q, k, v, heads, "flash_attention")
    d, dp, (q, k, v) = _padded("K1", dtype, heads, q, k, v)
    b, n, hc = q.shape
    m = k.shape[1]
    out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
           if need_lse else None)
    handle = lib("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, heads, n, m, hc // heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            float(scale))
    if dtype is torch.float32:
        # K and V split (and V transposed) once a call into a workspace of
        # this call's shape, on the caller's stream; none at d 512
        nbytes = handle.llt2i_flash_fwd_f32_ws(b, heads, m, hc // heads)
        ws = (torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
              if nbytes else None)
        args += (None if ws is None else ws.data_ptr(),)
    check(getattr(handle, _ENTRY[dtype][0])(
        *args, stream_handle(q.get_device())), "flash_attention")
    flash_attention.launches += 1
    if dtype is torch.float32:
        flash_attention.f32_launches += 1
    return (unpad_heads(out, heads, d) if dp != d else out), lse


def _check_bwd(q, k, v, dout, lse, delta, heads, what):
    """As ``_check_qkv``, and dout contiguous of q's type and shape. Returns
    the operand type."""
    dtype = _check_qkv(q, k, v, heads, what)
    b, n, _ = q.shape
    require(dout.shape == q.shape and dout.dtype == q.dtype
            and dout.is_cuda and dout.get_device() == q.get_device()
            and dout.is_contiguous(),
            f"{what}: dout must be contiguous, of q's dtype and shape")
    for name, t in (("lse", lse), ("delta", delta)):
        require(t.shape == (b, heads, n) and t.dtype == torch.float32
                and t.is_cuda and t.get_device() == q.get_device()
                and t.is_contiguous(),
                f"{what}: {name} must be contiguous f32 (B, H, N)")
    return dtype


# bits of a K5 f32 call's ``prepare``: its pre-pass writes what K5a (1)
# and K5b (2) read into the workspace
PREPARE_DQ, PREPARE_DKV = 1, 2


def bwd_f32_workspace(q: torch.Tensor, k: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """The K5a/K5b f32 workspace of one backward call, on q's device and
    the caller's stream: ``llt2i_flash_bwd_f32_ws`` bytes at the padded
    head dim (none at a head dim the kernels refuse, which then raise)."""
    b, n, hc = q.shape
    nbytes = lib("flash_attention").llt2i_flash_bwd_f32_ws(
        b, heads, n, k.shape[1], padded_head_dim(hc // heads, torch.float32))
    return torch.empty(nbytes // 4, dtype=torch.float32,
                       device=q.device) if nbytes else None


def _f32_tail(q, k, heads, workspace, prepare, own):
    """The f32 entry points' workspace and prepare arguments: a workspace
    of the caller's (read as ``prepare`` says) or the call's own, filled
    by its pre-pass (``own``)."""
    if workspace is None:
        workspace, prepare = bwd_f32_workspace(q, k, heads), own
    elif prepare is None:
        prepare = own
    return (None if workspace is None else workspace.data_ptr(), prepare)


def _bwd_args(q, k, v, dout, lse, delta, heads):
    b, n, hc = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (b, heads, n, k.shape[1], hc // heads, q.stride(0), q.stride(1),
             k.stride(0), k.stride(1), v.stride(0), v.stride(1)))


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor, heads: int, scale: float, *,
                           workspace=None, prepare=None) -> torch.Tensor:
    """K5a: dQ (B, N, H*d) from the saved lse and delta. In f32 it reads
    ``workspace`` (``bwd_f32_workspace``), filled first by its pre-pass
    with what ``prepare`` asks (default: K5a's own); with no workspace it
    takes and fills its own."""
    if not use_kernel(q):
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads,
                                         scale)[0]
    dtype = _check_bwd(q, k, v, dout, lse, delta, heads,
                       "flash_attention_bwd_dq")
    d, dp, (q, k, v, dout) = _padded("K5a", dtype, heads, q, k, v, dout)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs, dims = _bwd_args(q, k, v, dout, lse, delta, heads)
    tail = (_f32_tail(q, k, heads, workspace, prepare, PREPARE_DQ)
            if dtype is torch.float32 else ())
    check(getattr(lib("flash_attention"), _ENTRY[dtype][1])(
        *ptrs, dq.data_ptr(), *dims, float(scale), *tail,
        stream_handle(q.get_device())),
        "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    if dtype is torch.float32:
        flash_attention_bwd_dq.f32_launches += 1
    return unpad_heads(dq, heads, d) if dp != d else dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor, heads: int, scale: float, *,
                            workspace=None, prepare=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5b: (dK, dV), each (B, M, H*d), from the saved lse and delta; in
    f32 its workspace as K5a's (default ``prepare``: K5b's own)."""
    if not use_kernel(q):
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads,
                                         scale)[1:]
    dtype = _check_bwd(q, k, v, dout, lse, delta, heads,
                       "flash_attention_bwd_dkv")
    d, dp, (q, k, v, dout) = _padded("K5b", dtype, heads, q, k, v, dout)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    ptrs, dims = _bwd_args(q, k, v, dout, lse, delta, heads)
    tail = (_f32_tail(q, k, heads, workspace, prepare, PREPARE_DKV)
            if dtype is torch.float32 else ())
    check(getattr(lib("flash_attention"), _ENTRY[dtype][2])(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, float(scale), *tail,
        stream_handle(q.get_device())), "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    if dtype is torch.float32:
        flash_attention_bwd_dkv.f32_launches += 1
    if dp != d:
        dk, dv = unpad_heads(dk, heads, d), unpad_heads(dv, heads, d)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 with the lse forward, K5a/K5b backward; on CPU tensors the plain
    versions of both (the backward then is ``flash_attention_bwd_plain``,
    not autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        # the backward takes the forward's route: autograd runs it on its
        # own thread, which does not see a plain_route() around the call
        ctx.kernel = use_kernel(q)
        if ctx.kernel:
            out, lse = _launch_fwd(q, k, v, heads, scale, need_lse=True)
        else:
            out, lse = flash_attention_lse_plain(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout, ctx.heads)
        if ctx.kernel:
            # in f32 one workspace for the pair, filled once by K5a's call
            ws = (bwd_f32_workspace(q, k, ctx.heads)
                  if q.dtype is torch.float32 else None)
            dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.heads,
                                        ctx.scale, workspace=ws,
                                        prepare=PREPARE_DQ | PREPARE_DKV)
            dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                             ctx.heads, ctx.scale,
                                             workspace=ws, prepare=0)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                   ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """q: (B, N, H*d); k, v: (B, M, H*d) -> (B, N, H*d)."""
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, heads, scale)
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, heads, scale)
    return _launch_fwd(q, k, v, heads, scale, need_lse=False)[0]


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
# the f32 forms' shares of ``launches``
flash_attention.f32_launches = 0
flash_attention_bwd_dq.f32_launches = 0
flash_attention_bwd_dkv.f32_launches = 0
