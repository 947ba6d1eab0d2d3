"""Model building blocks of the dense GQA, MLA, MoE, Mamba and
encoder-decoder families: norms, RoPE, GQA (with the encoder-decoder's cross
attention) and multi-head latent attention, the SwiGLU / GELU MLP, the MoE
block and the Mamba block.

The port of ``repro.models.layers``' dense, MLA, MoE and Mamba parts.  Functions
are pure (parameters in, activations out) over dicts of tensors with the
reference's names, and follow its casts one for one:

* ``_dot`` multiplies in the activation dtype with f32 accumulation and one
  rounding to that dtype (the reference's ``preferred_element_type=F32``
  then ``astype``);
* ``rmsnorm`` normalises in f32 and rounds before the scale multiply;
* SwiGLU's ``silu`` runs in f32 and is rounded before ``* up``;
* the rotary angles and the rotation are float64, as the reference's are
  (its package enables x64, so ``rope_freqs`` multiplies by a float64 numpy
  vector), and the result is cast to the activation dtype.

``sdpa`` is the ``flash_attention`` kernel (its plain version on the CPU),
where the reference inlines a jnp double scan of the same function.  The
kernel keeps the probabilities in f32 before P.V, as the TPU kernel and its
oracle do; the reference's jnp form rounds them to bf16 first.  The kernel
takes one head dim for q, k and v, as the TPU kernel does; where v is
narrower (MLA: q and k 96 wide, v 64), ``sdpa`` zero-pads v to q's width in
the copy it makes anyway and cuts the output back, which is exact: zero
columns of V add nothing to the others of P.V.  Its tensor-parallel hooks
(``_tp``) have nothing to pin on one card: ``set_tp_context`` records a
launcher's context as the reference's does, and every tensor stays whole,
as the reference's do with the context unset.

``mla_attention`` is the reference's MLA step for step: prefill folds the
no-position and rotary parts of q and k into one head dim for ``sdpa``;
decode caches the compressed ``c_kv`` and the rotated ``k_rope`` a token,
expands the whole cache through ``wkv_b`` and scores it in f32.

``moe_block`` is the reference's sort-based capacity dispatch step for step:
the same top-k order on ties (the lower expert first), a stable sort of the
(token, choice) pairs by expert, the same capacity and so the same dropped
pairs; its expert products are batched products with an f32 result
(``_bmm_f32``), outside any kernel, as the reference leaves them to XLA.

``mamba_block``'s scan over a sequence is the ``mamba_scan`` kernel, the
exact recurrence, where the reference calls its chunked jnp scan
(``_ssm_chunked_scan``); the two agree at the reference's init scales, and
on decay-heavy inputs the chunked scan drops terms (``ROADMAP.md``, queue 3,
entry 14).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

F32 = torch.float32

#: the tensor-parallel context a launcher sets before a step
#: (``set_tp_context``): ``(mesh, data axes)`` or None.  The reference pins
#: layer intermediates to model-axis shardings under it; one card has
#: nothing to pin.
_TP_CTX = None


def set_tp_context(mesh, data_axes):
    """Record the tensor-parallel context (``mesh=None`` clears it), as the
    reference's launchers do before tracing."""
    global _TP_CTX
    _TP_CTX = None if mesh is None else (mesh, tuple(data_axes))


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32 and rounded once to x's dtype."""
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def apply_norm(cfg: ArchConfig, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def init_norm(cfg: ArchConfig, dim: int, *, layers: int = 0, device=None) -> dict:
    """Scale (and bias for layernorm) of one norm; ``layers > 0`` stacks
    them ``[layers, dim]``."""
    shape = (layers, dim) if layers else (dim,)
    dt = torch_dtype(cfg)
    p = {"scale": torch.ones(shape, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dt, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(
    dim: int, theta: float, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 ``cos, sin`` of ``positions[..., None] * inv`` (the positions
    pass through f32 first, as the reference's do)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2) / dim))
    inv = torch.from_numpy(inv).to(positions.device)
    ang = positions[..., None].float().double() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., S, H, Dh]; cos/sin broadcastable against [..., S, H, Dh/2]
    (callers pass ``cos[:, None, :]``); rotates in float64, casts back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


#: profiler range around ``sdpa``'s layout copies
SDPA_TRANSPOSES = "sdpa transposes"


def sdpa(q, k, v, *, causal: bool, scale=None):
    """Attention through the ``flash_attention`` kernel.

    q: [B, Sq, H, Dq]; k: [B, Sk, HKV, Dq]; v: [B, Sk, HKV, Dv] with Dv <=
    Dq (the reference's layout); returns [B, Sq, H, Dv].  The kernel takes
    heads before positions and one head dim, so the operands are transposed
    into contiguous copies, v's zero-padded to Dq, and the output's first Dv
    columns copied back; the copies run under the profiler range
    ``SDPA_TRANSPOSES``.  ``scale`` defaults to ``1 / sqrt(Dq)``.  The
    causal diagonal sits at ``Sk - Sq`` (the reference's callers use Sq =
    Sk, offset 0)."""
    dq, dv = q.shape[-1], v.shape[-1]
    if dv > dq:
        raise ValueError(f"sdpa: v's head dim {dv} is wider than q's {dq}")
    with torch.autograd.profiler.record_function(SDPA_TRANSPOSES):
        q, k = (x.transpose(1, 2).contiguous() for x in (q, k))
        if dv < dq:
            b, sk, hkv, _ = v.shape
            vp = v.new_zeros((b, hkv, sk, dq))
            vp[..., :dv] = v.transpose(1, 2)
            v = vp
        else:
            v = v.transpose(1, 2).contiguous()
    o = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    with torch.autograd.profiler.record_function(SDPA_TRANSPOSES):
        return o[..., :dv].transpose(1, 2).contiguous()


def _normal(shape, std, dt, gen, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dt, device=device)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dt)


def _stacked(layers, shape, std, dt, gen, device):
    """``[layers, *shape]`` of N(0, std), drawn a layer at a time so the f32
    draw never exceeds one layer (on the meta device, nothing is drawn)."""
    if torch.device(device).type == "meta":
        return torch.empty((layers, *shape), dtype=dt, device=device)
    out = torch.empty((layers, *shape), dtype=dt, device=device)
    for i in range(layers):
        out[i] = _normal(shape, std, dt, gen, device)
    return out


def init_gqa(cfg: ArchConfig, gen: torch.Generator, *, layers: int, device=None) -> dict:
    """GQA projections stacked ``[layers, ...]`` at the reference's scales."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    dt = torch_dtype(cfg)
    n = layers

    def w(shape, std):
        return _stacked(n, shape, std, dt, gen, device)

    p = {
        "wq": w((d, h * hd), s),
        "wk": w((d, hkv * hd), s),
        "wv": w((d, hkv * hd), s),
        "wo": w((h * hd, d), s / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((n, hkv * hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((n, hkv * hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n, hd), dtype=dt, device=device)
        p["k_norm"] = torch.ones((n, hd), dtype=dt, device=device)
    return p


def _dus(buf, update, at, axis: int):
    """Write ``update`` into ``buf`` at ``at`` along ``axis``, in place; the
    start clamps so the update fits, as ``dynamic_update_slice``'s does."""
    at = min(max(int(at), 0), buf.shape[axis] - update.shape[axis])
    buf.narrow(axis, at, update.shape[axis]).copy_(update)
    return buf


def gqa_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [S] absolute positions
    *,
    causal: bool = True,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[int] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Returns ``(out [B, S, D], new_kv_cache or None)``.  With a dense
    ``kv_cache`` ([B, Smax, HKV, Dh] k and v) the new keys and values are
    written into it in place at ``cache_len`` and the queries attend over
    it; without one, ``sdpa``.  With ``cross_kv`` (an encoder-decoder's
    cross attention: k and v [B, T, HKV, Dh], projected from the encoder's
    output by the caller) only q is projected, neither side is rotated nor
    k normed, and the queries attend over all of k through ``sdpa``,
    whatever ``causal`` says."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _dot(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, h, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if cross_kv is not None:
        o = sdpa(q, *cross_kv, causal=False)
        return _dot(o.reshape(b, s, h * hd), p["wo"]), None
    k = _dot(x, p["wk"])
    v = _dot(x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    q = apply_rope(q, cos[:, None, :], sin[:, None, :])
    k = apply_rope(k, cos[:, None, :], sin[:, None, :])

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        _dus(ck, k, cache_len, axis=1)
        _dus(cv, v, cache_len, axis=1)
        new_cache = (ck, cv)
        smax = ck.shape[1]
        kpos = torch.arange(smax, device=x.device)
        keep = kpos < (int(cache_len) + s)
        qf = q.reshape(b, s, hkv, h // hkv, hd).float() / math.sqrt(hd)
        sc = torch.einsum("bqngd,bknd->bnqgk", qf, ck.float())
        sc = sc.masked_fill(~keep[None, None, None, None, :], float("-inf"))
        mask = positions[:, None] >= kpos[None, :]
        sc = sc.masked_fill(~mask[None, None, :, None, :], float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        o = torch.einsum("bnqgk,bknd->bqngd", pr, cv.float())
        o = o.reshape(b, s, h, hd).to(x.dtype)
    else:
        o = sdpa(q, k, v, causal=causal)
    out = _dot(o.reshape(b, s, h * hd), p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek style)
# ---------------------------------------------------------------------------


def init_mla(cfg: ArchConfig, gen: torch.Generator, *, layers: int, device=None) -> dict:
    """MLA projections stacked ``[layers, ...]`` at the reference's scales:
    the q down- and up-projections ``wq_a`` [D, q_lora], ``wq_b`` [q_lora,
    H (nope + rope)], the kv down-projection ``wkv_a`` [D, kv_lora + rope]
    and up-projection ``wkv_b`` [kv_lora, H (nope + v)], ``wo`` [H v, D],
    and the two norms' scales."""
    d, h = cfg.d_model, cfg.n_heads
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s = 1.0 / math.sqrt(d)
    dt = torch_dtype(cfg)

    def w(shape, std):
        return _stacked(layers, shape, std, dt, gen, device)

    return {
        "wq_a": w((d, qlr), s),
        "q_norm": torch.ones((layers, qlr), dtype=dt, device=device),
        "wq_b": w((qlr, h * (nope + rope_d)), 1.0 / math.sqrt(qlr)),
        "wkv_a": w((d, kvlr + rope_d), s),
        "kv_norm": torch.ones((layers, kvlr), dtype=dt, device=device),
        "wkv_b": w((kvlr, h * (nope + vd)), 1.0 / math.sqrt(kvlr)),
        "wo": w((h * vd, d), s / math.sqrt(2 * cfg.n_layers)),
    }


def mla_attention(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [S] absolute positions
    *,
    causal: bool = True,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[int] = None,
):
    """Returns ``(out [B, S, D], new_kv_cache or None)``.  With a
    compressed ``kv_cache`` (``c_kv`` [B, Smax, kv_lora], ``k_rope`` [B,
    Smax, rope]) the new token's normed ``c_kv`` and rotated ``k_rope`` are
    written into it in place at ``cache_len``, the whole cache is expanded
    through ``wkv_b`` and the queries score it in f32; without one, the
    no-position and rotary parts fold into one head dim of nope + rope for
    ``sdpa``, v keeping its own width."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvlr = cfg.kv_lora_rank

    q = _dot(rmsnorm(_dot(x, p["wq_a"]), p["q_norm"], cfg.norm_eps), p["wq_b"])
    q = q.reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv_a = _dot(x, p["wkv_a"])  # [B, S, kv_lora + rope]
    c_kv, k_rope = kv_a[..., :kvlr], kv_a[..., kvlr:]
    c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)

    cos, sin = rope_freqs(rope_d, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos[:, None, :], sin[:, None, :])
    k_rope = apply_rope(k_rope[:, :, None, :], cos[:, None, :], sin[:, None, :])[:, :, 0]

    new_cache = None
    if kv_cache is not None:
        cc, cr = kv_cache
        _dus(cc, c_kv, cache_len, axis=1)
        _dus(cr, k_rope, cache_len, axis=1)
        new_cache = (cc, cr)
        c_all, r_all = cc, cr
        smax = cc.shape[1]
    else:
        c_all, r_all = c_kv, k_rope
        smax = s

    kv = _dot(c_all, p["wkv_b"]).reshape(b, smax, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]

    scale = 1.0 / math.sqrt(nope + rope_d)
    if kv_cache is None:
        qh = torch.cat([q_nope, q_rope], dim=-1)
        kh = torch.cat([k_nope, r_all[:, :, None, :].expand(b, smax, h, rope_d)], dim=-1)
        o = sdpa(qh, kh, v, causal=causal, scale=scale)
    else:
        sc = (
            torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
            + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), r_all.float())
        ) * scale
        kpos = torch.arange(smax, device=x.device)
        mask = positions[:, None] >= kpos[None, :]
        mask = mask & (kpos[None, :] < int(cache_len) + s)
        sc = sc.masked_fill(~mask[None, None], float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, v.float())
    out = _dot(o.reshape(b, s, h * vd).to(x.dtype), p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, gen: torch.Generator, *, layers: int, device=None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg)
    width = 2 * ff if cfg.act == "swiglu" else ff
    return {
        "wi": _stacked(layers, (d, width), 1.0 / math.sqrt(d), dt, gen, device),
        "wo": _stacked(
            layers, (ff, d), 1.0 / math.sqrt(ff) / math.sqrt(2 * cfg.n_layers),
            dt, gen, device,
        ),
    }


def mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = _dot(x, p["wi"])
    if cfg.act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    else:
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return _dot(h, p["wo"])


# ---------------------------------------------------------------------------
# MoE (capacity-based top-k dispatch)
# ---------------------------------------------------------------------------

#: profiler range around each chunk's dispatch, expert products and combine
MOE_BLOCK = "moe block"


def init_moe(cfg: ArchConfig, gen: torch.Generator, *, layers: int, device=None) -> dict:
    """An MoE block's leaves stacked ``[layers, ...]`` at the reference's
    scales: the router ``[D, E]`` in f32 whatever the model's dtype, ``wi``
    ``[E, D, 2F]`` (SwiGLU) or ``[E, D, F]``, ``wo`` ``[E, F, D]``."""
    d, e, ffe = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    dt = torch_dtype(cfg)
    s = 1.0 / math.sqrt(d)
    width = 2 * ffe if cfg.act == "swiglu" else ffe
    return {
        "router": _stacked(layers, (d, e), s, F32, gen, device),
        "wi": _stacked(layers, (e, d, width), s, dt, gen, device),
        "wo": _stacked(
            layers, (e, ffe, d), 1.0 / math.sqrt(ffe) / math.sqrt(2 * cfg.n_layers),
            dt, gen, device,
        ),
    }


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Slots an expert has for a chunk of ``t`` tokens."""
    return max(1, int(t * cfg.top_k / cfg.n_experts * cfg.moe_capacity_factor))


def moe_route(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor):
    """Top-k routing of the tokens ``xt`` [T, D]: ``(probs [T, E], idx [T,
    k], gates [T, k])``, probabilities and gates in f32, the gates
    renormalised over the k choices.  A stable descending sort takes the
    lower expert first on ties, as ``lax.top_k`` does."""
    probs = torch.softmax(torch.matmul(xt.float(), router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, : cfg.top_k], idx[:, : cfg.top_k]
    return probs, idx, gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)


def moe_queue(idx: torch.Tensor, cap: int):
    """The (token, choice) pairs ``idx.reshape(-1)`` in each expert's queue:
    ``(order, expert, rank, keep)``, the pairs sorted stably by expert (so
    in token order within one), each one's rank in its expert's queue, and
    whether that rank is within the capacity.  Nothing here waits for the
    card (a ``bincount`` would: it sizes its output on the host)."""
    expert, order = torch.sort(idx.reshape(-1), stable=True)
    start = torch.searchsorted(expert, expert)  # the first pair of each one's expert
    rank = torch.arange(expert.numel(), device=expert.device) - start
    return order, expert, rank, rank < cap


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with f32 accumulation and an f32 result (the
    reference's ``preferred_element_type=F32``): on the card a bf16 product
    asks for the f32 output directly (``BmmF32``, which gives it a
    gradient), and so does the meta device, which stands for it; the CPU
    has no such product, so it multiplies f32 copies."""
    if a.dtype == F32:
        return torch.bmm(a, b)
    if a.device.type != "cpu":
        return BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


class BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=F32)`` with its gradient, which torch
    does not define for that form: the f32 output gradient times the other
    operand in f32, rounded to each operand's dtype, as the reference
    differentiates its f32-result product (and as the CPU path's f32
    copies do)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = torch.bmm(g, b.float().mT).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = torch.bmm(a.float().mT, g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def _moe_chunk(cfg: ArchConfig, p: dict, xt: torch.Tensor, with_aux: bool = True):
    """One dispatch over the tokens ``xt`` [T, D]: ``(out [T, D], aux)``,
    aux None unless ``with_aux``."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    probs, idx, gates = moe_route(cfg, p["router"], xt)
    cap = moe_capacity(cfg, t)
    order, expert, rank, keep = moe_queue(idx, cap)
    # each kept pair's slot in the [E, cap] buffers; a dropped pair writes
    # into an extra row, cut off after
    slot_e = torch.where(keep, expert, e)
    slot_c = torch.where(keep, rank, 0)
    tok = torch.arange(t * k, device=dev) // k
    tok_buf = torch.full((e + 1, cap), t, dtype=torch.long, device=dev)  # t: no token
    tok_buf[slot_e, slot_c] = tok[order]
    gate_buf = torch.zeros((e + 1, cap), dtype=F32, device=dev)
    gate_buf[slot_e, slot_c] = gates.reshape(-1)[order]
    tok_buf, gate_buf = tok_buf[:e], gate_buf[:e]

    # each slot's token activations ([E, cap, D]; an empty slot reads zeros)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    expert_in = xt_pad[tok_buf]
    h = _bmm_f32(expert_in, p["wi"])
    if cfg.act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = torch.nn.functional.silu(gate) * up
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    out_e = _bmm_f32(h.to(xt.dtype), p["wo"])

    # combine: the gated expert outputs added back to their tokens in f32
    out = torch.zeros((t + 1, d), dtype=F32, device=dev)
    out.index_add_(0, tok_buf.reshape(-1), (out_e * gate_buf[..., None]).reshape(-1, d))

    out = out[:t].to(xt.dtype)
    if not with_aux:
        return out, None
    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(0)
    return out, (me * ce).sum() * e


def moe_block(
    cfg: ArchConfig, p: dict, x: torch.Tensor, *, with_aux: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(out [B, S, D], aux)``: the tokens dispatched in chunks of
    at most 8,192 (cut down until they divide B x S), each chunk its own
    capacity, so the chunking decides which pairs are dropped; ``aux`` is
    the chunks' mean, or None without ``with_aux`` (serving never reads
    it, so it launches none of its kernels).  Each chunk runs under the
    profiler range ``MOE_BLOCK``."""
    b, s, d = x.shape
    t_full = b * s
    chunk = min(t_full, 8192)
    while t_full % chunk:
        chunk -= 1
    outs, auxes = [], []
    for xt in x.reshape(t_full // chunk, chunk, d):
        with torch.autograd.profiler.record_function(MOE_BLOCK):
            o, a = _moe_chunk(cfg, p, xt, with_aux)
        outs.append(o)
        auxes.append(a)
    out = torch.cat(outs).reshape(b, s, d)
    if not with_aux:
        return out, None
    return out, sum(auxes) / len(auxes)


# ---------------------------------------------------------------------------
# Mamba (selective scan, diagonal A)
# ---------------------------------------------------------------------------


def init_mamba(cfg: ArchConfig, gen: torch.Generator, *, layers: int, device=None) -> dict:
    """A Mamba block's leaves stacked ``[layers, ...]``, at the reference's
    scales and dtypes: ``A_log``, ``dt_bias`` and ``D_skip`` in f32, the
    rest in the model's dtype."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)
    dt = torch_dtype(cfg)

    def w(shape, std):
        return _stacked(layers, shape, std, dt, gen, device)

    a_init = (1.0 + torch.arange(n, dtype=F32, device=device)) / n  # -A
    return {
        "in_proj": w((d, 2 * di), 1.0 / math.sqrt(d)),
        "conv": w((cfg.ssm_conv, di), 0.1),
        "conv_bias": torch.zeros((layers, di), dtype=dt, device=device),
        "x_proj": w((di, dt_rank + 2 * n), 1.0 / math.sqrt(di)),
        "dt_proj": w((dt_rank, di), 1.0 / math.sqrt(dt_rank)),
        "dt_bias": torch.full((layers, di), -4.0, dtype=F32, device=device),
        "A_log": torch.log(a_init).expand(layers, di, n).contiguous(),
        "D_skip": torch.ones((layers, di), dtype=F32, device=device),
        "out_proj": w((di, d), 1.0 / math.sqrt(di) / math.sqrt(2 * cfg.n_layers)),
    }


def mamba_block(
    cfg: ArchConfig,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    *,
    ssm_state: Optional[torch.Tensor] = None,  # [B, Di, N] decode carry
    conv_state: Optional[torch.Tensor] = None,  # [B, conv - 1, Di]
):
    """Returns ``(out [B, S, D], new_ssm_state [B, Di, N] f32,
    new_conv_state [B, conv - 1, Di] f32)``.  One token with a state takes
    the inline recurrence, as the reference does; a sequence starts from a
    zero state and runs the ``mamba_scan`` kernel (its plain version on the
    CPU), whose final state is the new state.  Under grad the scan is
    ``ops.MambaScan``, whose backward is the ``mamba_scan_bwd`` kernel: the
    gradient reaches every leaf, through the contiguous copies of ``B``,
    ``C`` and ``xs`` and through ``A = -exp(A_log)``."""
    b, s, d = x.shape
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)

    xs, z = _dot(x, p["in_proj"]).chunk(2, dim=-1)  # [B, S, Di]

    # depthwise causal conv over time
    w = p["conv"]  # [K, Di]
    kk = w.shape[0]
    if conv_state is not None:
        ctx = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    else:
        ctx = torch.nn.functional.pad(xs, (0, 0, kk - 1, 0))
    new_conv_state = ctx[:, s:].float()  # the last conv - 1 inputs
    conv_out = sum(ctx[:, i : i + s].float() * w[i].float() for i in range(kk))
    conv_out = conv_out + p["conv_bias"].float()
    xs = torch.nn.functional.silu(conv_out).to(x.dtype)

    dtv, bmat, cmat = _dot(xs, p["x_proj"]).split([dt_rank, n, n], dim=-1)
    v = torch.matmul(dtv.float(), p["dt_proj"].float()) + p["dt_bias"]
    delta = torch.logaddexp(v, torch.zeros((), dtype=F32, device=v.device))  # softplus
    A = -torch.exp(p["A_log"])  # [Di, N]

    if s == 1 and ssm_state is not None:
        dt0 = delta[:, 0, :, None]
        dbx = dt0 * bmat[:, 0, None, :].float() * xs[:, 0, :, None].float()
        h = torch.exp(dt0 * A) * ssm_state + dbx
        y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].float())[:, None]
        new_state = h
    else:
        # bmat and cmat are strided slices of x_dbl: the kernel takes them
        # contiguous
        y, new_state = ops.mamba_scan(
            delta, A, bmat.contiguous(), cmat.contiguous(), xs.contiguous()
        )

    y = y + p["D_skip"] * xs.float()
    y = y * torch.nn.functional.silu(z.float())
    out = _dot(y.to(x.dtype), p["out_proj"])
    return out, new_state, new_conv_state
