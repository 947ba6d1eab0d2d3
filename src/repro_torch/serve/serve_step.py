"""Serving steps: prefill (every family) and paged decode (the GQA and MoE
families).

``paged_decode_step`` is the data-plane consumer of the DEX page table: one
new token per request, attention over the paged pool through the
``paged_attention`` kernel in every layer (its plain version with
``use_kernel=False``).  ``prefill`` is the training forward: its attention
is the ``flash_attention`` kernel and its Mamba layers' scans the
``mamba_scan`` kernel.  An SSM or hybrid model decodes through
``models/model.py::decode_step``, whose recurrent state has no pages; like
the reference, nothing prefills a prompt into that state: prompts are fed a
token a step.  An MLA model decodes through ``decode_step`` too, over its
compressed dense cache: the reference's paged step reads the GQA
projections ``wq``, ``wk`` and ``wv``, which an MLA block does not have.  An
encoder-decoder model decodes through ``decode_step`` too, over its dense
self and cross caches (``prefill_cross_kv`` fills the cross one): the
reference's paged step never reads a block's cross attention, so it would
decode without it (``ROADMAP.md``, queue 3); the port refuses it.

The port of ``repro.serve.serve_step``.  The history and the fresh token are
blended as the reference blends them: the softmax over the history, weighed
against the fresh token's own logit by the history's log-sum-exp, but
max-shifted (``blend``), where the reference's exponentials overflow float32
above 88.7 and give NaN.  The
kernel returns that log-sum-exp beside its output; the plain path
(``use_kernel=False``) keeps the reference's dense regather of the history's
logits (``kp[page_table]``), so it stays the reference's computation.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig

#: profiler range around the plain path's regather of the history's logits
REGATHER = "history regather"

F32 = torch.float32


def prefill(cfg: ArchConfig, params, tokens, cache=None, *, enc_emb=None):
    """Teacher-forced prefill through the training forward; returns the
    logits [B, S, V] f32 (``cache`` is unused, as in the reference; the
    MoE aux loss is not computed).  An encoder-decoder model takes its
    frame embeddings ``enc_emb`` [B, T, D]."""
    logits, _ = M.forward(cfg, params, tokens, enc_emb=enc_emb, with_aux=False)
    return logits


def blend(o_hist, lse_hist, s_self, v_self, has_hist):
    """``[B, n, g, d]`` f32: the attention output over a request's history
    and its fresh token, each row the softmax over both.  ``o_hist`` [B, n,
    g, d] f32 is the history's output, ``lse_hist`` [B, n, g] its
    log-sum-exp, ``s_self`` [B, n, g] the fresh key's logit, ``v_self`` [B,
    n, 1, d] its value, ``has_hist`` [B, 1, 1] whether the history is
    non-empty (if not, the fresh value alone).  The weights are
    max-shifted: ``exp(lse) / (exp(lse) + exp(s)) = sigmoid(lse - s)``,
    finite where either exponential would overflow float32 (above 88.7)."""
    w_hist = torch.where(has_hist, torch.sigmoid(lse_hist - s_self), 0.0)
    w_self = torch.where(has_hist, 1.0 - w_hist, 1.0)
    # an empty history's softmax is NaN in the plain version (0 from the
    # kernel); it has weight 0, so sanitise before the blend
    return torch.nan_to_num(o_hist) * w_hist[..., None] + v_self * w_self[..., None]


def paged_decode_step(
    cfg: ArchConfig,
    params: Dict,
    tokens: torch.Tensor,  # [B, 1] current tokens
    k_pages: torch.Tensor,  # [L, P, page, HKV, Dh]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, ppr] int32 (resolved by the DEX index)
    seq_lens: torch.Tensor,  # [B] int32 (lengths INCLUDING the current token)
    *,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over the paged pool.

    Returns ``(logits [B, V] f32, k_new [L, B, HKV, Dh], v_new)``; the host
    scatters k_new / v_new into the pool with
    ``PagedKVCache.append_tokens`` (the token attends to itself here, so
    the scatter may land after the step)."""
    if cfg.ssm:
        raise ValueError(
            f"{cfg.name}: paged decode serves attention models; an SSM or hybrid"
            " model decodes through model.decode_step"
        )
    if cfg.attention == "mla":
        raise ValueError(
            f"{cfg.name}: paged decode serves GQA models; an MLA model decodes"
            " through model.decode_step over its compressed cache"
        )
    if cfg.encdec:
        raise ValueError(
            f"{cfg.name}: paged decode has no cross attention; an encoder-decoder"
            " model decodes through model.decode_step over its cross cache"
        )
    b = tokens.shape[0]
    hkv, hd, h = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    g = h // hkv
    x = M._embed(cfg, params, tokens)  # [B, 1, D]
    positions = seq_lens - 1  # [B]
    cos, sin = L.rope_freqs(hd, cfg.rope_theta, positions[:, None])  # [B, 1, hd/2]
    cos, sin = cos[..., None, :], sin[..., None, :]
    ppr, page = page_table.shape[1], k_pages.shape[2]
    if not use_kernel:  # the plain path regathers the history's logits
        hist = torch.arange(ppr * page, device=x.device)[None] < positions[:, None]
    has_hist = (positions > 0)[:, None, None]
    scale = 1.0 / math.sqrt(hd)
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        p = M.layer_params(params["blocks"], i)
        kp, vp = k_pages[i], v_pages[i]
        xin = L.apply_norm(cfg, x, p["ln1"])
        ap = p["attn"]
        q = L._dot(xin, ap["wq"])
        k = L._dot(xin, ap["wk"])
        v = L._dot(xin, ap["wv"])
        if cfg.qkv_bias:
            q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
        q = q.reshape(b, 1, h, hd)
        k = k.reshape(b, 1, hkv, hd)
        v = v.reshape(b, 1, hkv, hd)
        if cfg.qk_norm:
            q = L.rmsnorm(q, ap["q_norm"], cfg.norm_eps)
            k = L.rmsnorm(k, ap["k_norm"], cfg.norm_eps)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)

        # attend over the pool's pages, then blend in the fresh token as one
        # extra key with its own logit
        qg = q[:, 0].reshape(b, hkv, g, hd).float() * scale
        s_self = torch.einsum("bngd,bnd->bng", qg, k[:, 0].float())
        if use_kernel:
            o_hist, lse = ops.paged_attention(
                q[:, 0].contiguous(), kp, vp, page_table, positions, with_lse=True
            )
            lse_hist = lse.reshape(b, hkv, g)
        else:
            o_hist = kref.paged_attention_ref(
                q[:, 0].contiguous(), kp, vp, page_table, positions
            )
            with torch.autograd.profiler.record_function(REGATHER):
                kh = kp[page_table.long()].reshape(b, ppr * page, hkv, hd)
                sh = torch.einsum("bngd,bsnd->bngs", qg, kh.float())
                sh = sh.masked_fill(~hist[:, None, None, :], float("-inf"))
                lse_hist = torch.logsumexp(sh, dim=-1)  # [B, n, g]
        o = blend(o_hist.reshape(b, hkv, g, hd).float(), lse_hist, s_self,
                  v[:, 0].float()[:, :, None, :], has_hist)
        o = o.reshape(b, 1, h * hd).to(x.dtype)
        x, _ = M.ffn(cfg, p, x + L._dot(o, ap["wo"]))
        k_new.append(k[:, 0])
        v_new.append(v[:, 0])
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = M._logits(x[:, 0], M._head_of(cfg, params))
    return logits, torch.stack(k_new), torch.stack(v_new)
