"""The model: init, forward (train / prefill) and dense-cache decode for
the dense GQA, MLA, MoE, SSM, hybrid and encoder-decoder families.

The port of ``repro.models.model``'s dense path (families ``dense`` and
``vlm``: pre-norm GQA with optional QKV bias or QK-norm, then a SwiGLU or
GELU MLP), its MLA path (``attention == "mla"``, minicpm3-4b: multi-head
latent attention in place of GQA, whose dense decode cache holds the
compressed ``c_kv`` and the rotated ``k_rope`` a token), its MoE path
(``moe``: the same attention, then an MoE block in place of the MLP, whose
aux loss ``forward`` sums over the layers), its SSM
path (``ssm``: a pre-norm Mamba block a layer,
falcon-mamba-7b) and its hybrid path (a Mamba stack with one weight-shared
GQA block applied after every ``hybrid_attn_every`` layers, zamba2-2.7b) and
its encoder-decoder path (``encdec``, whisper-small: a non-causal GQA
encoder over the caller's frame embeddings, the conv front end being a stub
as in the reference, and a cross-attention sublayer in every decoder block
over the encoder's output, whose keys and values the dense decode cache
holds a layer, ``xk`` / ``xv``, filled once by ``prefill_cross_kv``).
Parameters are a dict of tensors with the reference's names and stacked
``[L, ...]`` leaves; ``params_from_numpy`` carries the reference's
parameter pytree across (as ``jax.tree.map(np.asarray, params)`` gives it),
the counterpart of ``dex.state_from_numpy``.  The layer stack is a Python
loop over those leaves, where the reference scans; ``forward`` unbinds each
stacked leaf once (``unbind_layers``), so a backward stacks each leaf's
gradient once, and under grad it checkpoints each block where
``cfg.remat`` asks (the reference's ``jax.checkpoint``).  The training
loss is ``loss_fn``, its cross entropy ``chunked_ce`` (chunks of positions,
each chunk's f32 logits recomputed in the backward).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.mesh import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

F32 = torch.float32

def layer_params(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of stacked ``[L, ...]`` leaves (views)."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()
    }


def unbind_layers(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The ``n`` layers' slices of stacked ``[n, ...]`` leaves, each leaf
    unbound once (views).  Its backward stacks each leaf's gradient once,
    where ``layer_params`` would allocate a zero tensor as large as the
    whole stack in every layer's backward (32 of about 7 GB a step for
    minitron-4b)."""
    layers: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unbind_layers(v, n) if isinstance(v, dict) else torch.unbind(v)
        for i in range(n):
            layers[i][k] = parts[i]
    return layers


def _tracks_grad(x: torch.Tensor, p: Dict[str, Any]) -> bool:
    """Whether autograd records a block of ``p`` applied to ``x``."""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    return any(
        _tracks_grad(x, v) if isinstance(v, dict) else v.requires_grad for v in p.values()
    )


def _remat(cfg: ArchConfig, fn, p, x, *args):
    """``fn(cfg, p, x, *args)``, checkpointed where ``cfg.remat`` asks and
    autograd records it: its activations are recomputed in the backward,
    as the reference's ``jax.checkpoint`` of each block does."""
    if cfg.remat and _tracks_grad(x, p):
        return checkpoint(fn, cfg, p, x, *args, use_reentrant=False)
    return fn(cfg, p, x, *args)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int, device=None) -> Dict[str, Any]:
    """Random weights at the reference's scales and dtypes, drawn on
    ``device`` (``None`` means CUDA) from a ``torch.Generator`` seeded with
    ``seed``.  The numbers differ from the reference's ``jax.random`` ones;
    tests carry the reference's parameters across with
    ``params_from_numpy``.  On the ``meta`` device (the dry-run) the leaves
    have their shapes and dtypes and no values, and no generator draws."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    dt = L.torch_dtype(cfg)
    n = cfg.n_layers
    params: Dict[str, Any] = {
        "embed": L._normal((cfg.vocab, cfg.d_model), 0.02, dt, gen, device),
        "final_norm": L.init_norm(cfg, cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal((cfg.d_model, cfg.vocab), 0.02, dt, gen, device)
    if cfg.ssm:
        params["blocks"] = {
            "ln1": L.init_norm(cfg, cfg.d_model, layers=n, device=device),
            "ssm": L.init_mamba(cfg, gen, layers=n, device=device),
        }
    else:
        params["blocks"] = _init_attn_block(cfg, gen, n, device)
    if cfg.hybrid_attn_every:  # one weight-shared block, unstacked
        params["shared_attn"] = layer_params(_init_attn_block(cfg, gen, 1, device), 0)
    if cfg.encdec:
        params["encoder"] = _init_encoder(cfg, gen, device)
    return params


def _init_attn_block(cfg: ArchConfig, gen, layers: int, device):
    """A decoder block's leaves: ``attn`` from ``init_mla`` for an MLA
    config, ``moe`` in place of ``mlp`` for an MoE one, and the cross
    attention ``lnx`` / ``xattn`` for an encoder-decoder one."""
    init_attn = L.init_mla if cfg.attention == "mla" else L.init_gqa
    p = {
        "ln1": L.init_norm(cfg, cfg.d_model, layers=layers, device=device),
        "attn": init_attn(cfg, gen, layers=layers, device=device),
        "ln2": L.init_norm(cfg, cfg.d_model, layers=layers, device=device),
    }
    if cfg.moe:
        p["moe"] = L.init_moe(cfg, gen, layers=layers, device=device)
    else:
        p["mlp"] = L.init_mlp(cfg, gen, layers=layers, device=device)
    if cfg.encdec:
        p["lnx"] = L.init_norm(cfg, cfg.d_model, layers=layers, device=device)
        p["xattn"] = L.init_gqa(cfg, gen, layers=layers, device=device)
    return p


def _init_encoder(cfg: ArchConfig, gen, device):
    """The encoder's leaves: learned source positions ``pos``
    [max_source_positions, D] of N(0, 0.02), ``enc_layers`` stacked
    pre-norm GQA + MLP ``blocks`` and a ``final_norm``.  The encoder shares
    the config, so its output projections take the decoder's depth in their
    ``1 / sqrt(2 n_layers)`` scale, as the reference's do."""
    n = cfg.enc_layers
    return {
        "pos": L._normal(
            (cfg.max_source_positions, cfg.d_model), 0.02, L.torch_dtype(cfg), gen, device
        ),
        "blocks": {
            "ln1": L.init_norm(cfg, cfg.d_model, layers=n, device=device),
            "attn": L.init_gqa(cfg, gen, layers=n, device=device),
            "ln2": L.init_norm(cfg, cfg.d_model, layers=n, device=device),
            "mlp": L.init_mlp(cfg, gen, layers=n, device=device),
        },
        "final_norm": L.init_norm(cfg, cfg.d_model, device=device),
    }


def params_from_numpy(cfg: ArchConfig, tree: Dict[str, Any], device=None):
    """The reference's parameter pytree, leaves as numpy arrays, as tensors
    on ``device``.  bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy, or
    their ``uint16`` bit patterns) are carried bit for bit."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
            return t.view(torch.bfloat16).to(device)
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(v) for k, v in t.items()}

    return walk(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Tensors back to numpy; bfloat16 leaves come back as their ``uint16``
    bit patterns (numpy has no bfloat16 of its own:
    ``.view(ml_dtypes.bfloat16)`` restores the reference's dtype)."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return {
        k: params_to_numpy(v) if isinstance(v, dict) else leaf(v)
        for k, v in params.items()
    }


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params, tokens) -> torch.Tensor:
    return params["embed"][tokens.long()].to(L.torch_dtype(cfg))


def _head_of(cfg: ArchConfig, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x @ head`` with f32 accumulation and an f32 result, not rounded
    back (the reference's ``preferred_element_type=F32``).  On the card a
    bf16 product asks cuBLAS for the f32 output directly (``HeadProduct``),
    which spares an f32 copy of the 256k-row head on every decode step and
    every cross-entropy chunk; the CPU has no such product, so it
    multiplies f32 copies.  The meta device takes the card's path, whose
    memory and work it stands for."""
    if x.dtype == F32:
        return torch.matmul(x, head)
    if x.device.type != "cpu":
        out = HeadProduct.apply(x.reshape(-1, x.shape[-1]), head)
        return out.reshape(*x.shape[:-1], head.shape[-1])
    return torch.matmul(x.float(), head.float())


class HeadProduct(torch.autograd.Function):
    """``x [N, D] @ head [D, V]`` in bf16 with an f32 result
    (``torch.mm(..., out_dtype=float32)``), and its gradient: the f32
    output gradient is rounded once to bf16, then ``dx = g head^T`` and
    ``dhead = x^T g`` are bf16 products with f32 accumulation, each
    rounded once to bf16.  The reference multiplies the f32 gradient by the
    bf16 operand in f32; that would cost an f32 copy of the head and an f32
    product of 26 TFLOP a minitron-4b step, so only this rounding of the
    gradient (2^-9 relative) differs."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return torch.mm(x, head, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.mm(g, head.T) if ctx.needs_input_grad[0] else None
        dhead = torch.mm(x.T, g) if ctx.needs_input_grad[1] else None
        return dx, dhead


def ffn(cfg: ArchConfig, p, x, *, with_aux: bool = False):
    """The second half of an attention block: ``(x + MLP or MoE of the
    normed x, the MoE aux loss or None)``; the loss is computed only
    ``with_aux``."""
    xin = L.apply_norm(cfg, x, p["ln2"])
    if "moe" in p:
        h, aux = L.moe_block(cfg, p["moe"], xin, with_aux=with_aux)
        return x + h, aux
    return x + L.mlp(cfg, p["mlp"], xin), None


def _apply_block(cfg: ArchConfig, p, x, positions, with_aux: bool, enc_x=None):
    """One decoder block (a Mamba block for an SSM config), training /
    prefill path; also the hybrid's shared attention block.  With the
    encoder's output ``enc_x`` [B, T, D], the block's cross attention runs
    between its self-attention and its MLP, over keys and values projected
    from ``enc_x`` (no bias: the reference adds none).  Returns ``(x,
    aux)``, aux None but for an MoE block ``with_aux``."""
    if "ssm" in p:
        h, _, _ = L.mamba_block(cfg, p["ssm"], L.apply_norm(cfg, x, p["ln1"]))
        return x + h, None
    h, _ = _attention(cfg)(cfg, p["attn"], L.apply_norm(cfg, x, p["ln1"]), positions)
    x = x + h
    if enc_x is not None:
        h, _ = L.gqa_attention(
            cfg, p["xattn"], L.apply_norm(cfg, x, p["lnx"]), positions,
            cross_kv=_cross_kv(cfg, p["xattn"], enc_x),
        )
        x = x + h
    return ffn(cfg, p, x, with_aux=with_aux)


def _cross_kv(cfg: ArchConfig, p, enc_x: torch.Tensor):
    """One decoder layer's cross-attention keys and values, ``[B, T, HKV,
    Dh]`` each, projected from the encoder's output ``enc_x`` [B, T, D] by
    the layer's ``xattn`` leaves ``p``."""
    b, t, _ = enc_x.shape
    shape = (b, t, cfg.n_kv_heads, cfg.head_dim)
    return L._dot(enc_x, p["wk"]).reshape(shape), L._dot(enc_x, p["wv"]).reshape(shape)


def _encode(cfg: ArchConfig, params, enc_emb: torch.Tensor) -> torch.Tensor:
    """The encoder over the caller's frame embeddings ``enc_emb`` [B, T, D]
    in the model's dtype (the conv front end is a stub): the learned source
    positions added, ``enc_layers`` pre-norm blocks of non-causal GQA (with
    RoPE, as the reference has it) and the MLP, then the final norm.
    Raises ``ValueError`` without ``enc_emb`` or when T exceeds
    ``max_source_positions``."""
    if enc_emb is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs enc_emb [B, T, D]")
    shape = tuple(enc_emb.shape)
    if len(shape) != 3 or shape[2] != cfg.d_model or enc_emb.dtype != L.torch_dtype(cfg):
        raise ValueError(
            f"{cfg.name}: enc_emb must be [B, T, {cfg.d_model}] {cfg.dtype}, got"
            f" {shape} {enc_emb.dtype}"
        )
    t = shape[1]
    if t > cfg.max_source_positions:
        raise ValueError(
            f"{cfg.name}: {t} source frames, more than max_source_positions"
            f" {cfg.max_source_positions}"
        )
    enc = params["encoder"]
    x = enc_emb + enc["pos"][:t][None]
    positions = torch.arange(t, device=x.device)
    for p in unbind_layers(enc["blocks"], cfg.enc_layers):
        x = _remat(cfg, _encoder_block, p, x, positions)
    return L.apply_norm(cfg, x, enc["final_norm"])


def _encoder_block(cfg: ArchConfig, p, x, positions):
    """One pre-norm encoder block: non-causal GQA, then the MLP."""
    h, _ = L.gqa_attention(
        cfg, p["attn"], L.apply_norm(cfg, x, p["ln1"]), positions, causal=False
    )
    x = x + h
    return x + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, x, p["ln2"]))


def _attention(cfg: ArchConfig):
    """The config's attention layer: ``mla_attention`` or ``gqa_attention``
    (the hybrid's shared block is GQA)."""
    return L.mla_attention if cfg.attention == "mla" else L.gqa_attention


def _schedule(cfg: ArchConfig):
    """The stack in order: ``("block", i)`` for layer ``i``, ``("shared",
    g)`` for the hybrid's shared block after group ``g`` of
    ``hybrid_attn_every`` layers (the layers past the last whole group run
    after it, without one)."""
    every = cfg.hybrid_attn_every
    for i in range(cfg.n_layers):
        yield "block", i
        if every and (i + 1) % every == 0:
            yield "shared", i // every


def forward(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,  # [B, S] int
    *,
    enc_emb: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    with_aux: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(logits [B, S, V] f32, aux)`` (aux is the MoE loss summed
    over the layers, 0 without MoE blocks, None without ``with_aux``), or
    the final hidden states when ``return_hidden``.  An encoder-decoder
    model runs its encoder over ``enc_emb`` [B, T, D] first (``ValueError``
    without it).  Every attention is the ``flash_attention`` kernel, every
    Mamba layer's scan the ``mamba_scan`` kernel.  Under grad, each layer
    of the stack (and of the encoder) is checkpointed where ``cfg.remat``
    asks, a Mamba layer's scan then running twice (the checkpoint's forward
    without grad, the recompute with the states its backward kernel
    restarts from); the hybrid's shared block is not, as in the reference,
    and its gradient sums over its applications."""
    s = tokens.shape[1]
    enc_x = _encode(cfg, params, enc_emb) if cfg.encdec else None
    x = _embed(cfg, params, tokens)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=F32, device=x.device) if with_aux else None
    layers = unbind_layers(params["blocks"], cfg.n_layers)
    for kind, i in _schedule(cfg):
        if kind == "shared":
            x, a = _apply_block(cfg, params["shared_attn"], x, positions, with_aux, enc_x)
        else:
            x, a = _remat(cfg, _apply_block, layers[i], x, positions, with_aux, enc_x)
        if a is not None:
            aux = aux + a
    x = L.apply_norm(cfg, x, params["final_norm"])
    if return_hidden:
        return x, aux
    return _logits(x, _head_of(cfg, params)), aux


# ---------------------------------------------------------------------------
# the training loss
# ---------------------------------------------------------------------------


def _ce_chunk(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor):
    """One chunk's ``(sum of the NLL f32, count int32)`` over its positions
    whose label is not -100; its logits [B, c, V] are f32."""
    logits = _logits(h, head)
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum(dtype=torch.int32)


def chunked_ce(cfg: ArchConfig, params, hidden, labels, *, chunk: int = 512):
    """Cross entropy without the whole [B, S, V] f32 logits: the positions
    in chunks of ``chunk`` (cut down until it divides S), each chunk's
    logits checkpointed under grad, so its backward recomputes them, as the
    reference's ``jax.checkpoint`` of its scan body does.  Returns
    ``(sum_nll f32, count int32)``."""
    s = hidden.shape[1]
    c = min(chunk, s)
    while s % c:
        c -= 1
    head = _head_of(cfg, params)
    nll = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    grad = torch.is_grad_enabled() and (hidden.requires_grad or head.requires_grad)
    for h, lab in zip(hidden.split(c, dim=1), labels.split(c, dim=1)):
        if grad:
            n, k = checkpoint(_ce_chunk, h, head, lab, use_reentrant=False)
        else:
            n, k = _ce_chunk(h, head, lab)
        nll = nll + n
        cnt = cnt + k
    return nll, cnt


def loss_fn(cfg: ArchConfig, params, batch, *, ce_chunk: int = 512):
    """Next-token cross entropy plus 0.01 x the MoE aux loss: ``(total,
    {"ce", "moe_aux", "tokens"})``, all 0-dim tensors.  ``batch`` holds
    ``tokens`` [B, S] and ``labels`` [B, S] (-100 = ignore) on the
    parameters' device, and ``enc_emb`` [B, T, D] for an encoder-decoder
    model."""
    hidden, aux = forward(
        cfg, params, batch["tokens"], enc_emb=batch.get("enc_emb"), return_hidden=True
    )
    nll_sum, cnt = chunked_ce(cfg, params, hidden, batch["labels"], chunk=ce_chunk)
    denom = torch.clamp(cnt, min=1)
    ce = nll_sum / denom
    total = ce + 0.01 * aux
    return total, {"ce": ce, "moe_aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# decode (serving) with a dense cache
# ---------------------------------------------------------------------------


def init_decode_cache(
    cfg: ArchConfig, batch: int, max_len: int, device=None, enc_len: int = 0
) -> Dict[str, torch.Tensor]:
    """Dense (contiguous) decode cache: ``k``, ``v`` [L, B, max_len, HKV,
    Dh] for a GQA model; ``c_kv`` [L, B, max_len, kv_lora] and ``k_rope``
    [L, B, max_len, rope] for an MLA one, in the model's dtype; for an SSM
    or hybrid one the recurrent ``ssm`` [L, B, Di, N] and ``conv`` [L, B,
    conv - 1, Di] states in f32, and for
    the hybrid ``shared_k``, ``shared_v`` [groups, B, max_len, HKV, Dh] (one
    per application of the shared block); an encoder-decoder one adds the
    cross-attention ``xk``, ``xv`` [L, B, enc_len, HKV, Dh], which
    ``prefill_cross_kv`` fills.  The DEX-paged variant is
    ``serve/kv_cache.py``."""
    device = resolve_device(device)
    dt = L.torch_dtype(cfg)
    if cfg.ssm:
        di = cfg.ssm_expand * cfg.d_model
        nl = cfg.n_layers
        cache = {
            "ssm": torch.zeros((nl, batch, di, cfg.ssm_state), dtype=F32, device=device),
            "conv": torch.zeros((nl, batch, cfg.ssm_conv - 1, di), dtype=F32, device=device),
        }
        if cfg.hybrid_attn_every:
            groups = cfg.n_layers // cfg.hybrid_attn_every
            shape = (groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache["shared_k"] = torch.zeros(shape, dtype=dt, device=device)
            cache["shared_v"] = torch.zeros(shape, dtype=dt, device=device)
        return cache
    if cfg.attention == "mla":
        shape = (cfg.n_layers, batch, max_len)
        return {
            "c_kv": torch.zeros((*shape, cfg.kv_lora_rank), dtype=dt, device=device),
            "k_rope": torch.zeros((*shape, cfg.qk_rope_dim), dtype=dt, device=device),
        }
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }
    if cfg.encdec:
        shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        cache["xk"] = torch.zeros(shape, dtype=dt, device=device)
        cache["xv"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def prefill_cross_kv(cfg: ArchConfig, params, enc_emb: torch.Tensor, cache):
    """Run the encoder once over ``enc_emb`` [B, T, D] and write every
    decoder layer's cross-attention keys and values into ``cache["xk"]`` /
    ``cache["xv"]`` in place, a layer at a time (the reference builds new
    planes); returns the cache, whose planes must be [L, B, T, HKV, Dh]
    (``init_decode_cache(..., enc_len=T)``)."""
    enc_x = _encode(cfg, params, enc_emb)
    b, t, _ = enc_x.shape
    want = (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.head_dim)
    for key in ("xk", "xv"):
        got = tuple(cache[key].shape) if key in cache else None
        if got != want:
            raise ValueError(f"{cfg.name}: cache[{key!r}] must be {want}, got {got}")
    for i in range(cfg.n_layers):
        kx, vx = _cross_kv(cfg, layer_params(params["blocks"], i)["xattn"], enc_x)
        cache["xk"][i].copy_(kx)
        cache["xv"][i].copy_(vx)
    return cache


def decode_step(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,  # [B, 1]
    cache: Dict[str, torch.Tensor],
    pos: int,  # current length
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence.  Returns ``(logits [B, V], cache)``;
    the cache is written in place (the reference returns a new one).  A
    Mamba layer takes the inline one-token recurrence; an attention block
    (the hybrid's shared one too) attends over its dense cache, an MLA block
    over its compressed one; an encoder-decoder block then attends over its
    layer's ``xk`` / ``xv`` (``sdpa``, one query row)."""
    x = _embed(cfg, params, tokens)
    positions = torch.full((1,), int(pos), dtype=torch.int32, device=x.device)
    for kind, i in _schedule(cfg):
        if kind == "shared":
            p, kv = params["shared_attn"], (cache["shared_k"][i], cache["shared_v"][i])
        else:
            p = layer_params(params["blocks"], i)
            if cfg.ssm:
                h, new_ssm, new_conv = L.mamba_block(
                    cfg, p["ssm"], L.apply_norm(cfg, x, p["ln1"]),
                    ssm_state=cache["ssm"][i], conv_state=cache["conv"][i],
                )
                cache["ssm"][i].copy_(new_ssm)
                cache["conv"][i].copy_(new_conv)
                x = x + h
                continue
            if cfg.attention == "mla":
                kv = (cache["c_kv"][i], cache["k_rope"][i])
            else:
                kv = (cache["k"][i], cache["v"][i])
        h, _ = _attention(cfg)(
            cfg, p["attn"], L.apply_norm(cfg, x, p["ln1"]), positions,
            kv_cache=kv, cache_len=pos,
        )
        x = x + h
        if cfg.encdec:
            h, _ = L.gqa_attention(
                cfg, p["xattn"], L.apply_norm(cfg, x, p["lnx"]), positions,
                cross_kv=(cache["xk"][i], cache["xv"][i]),
            )
            x = x + h
        x, _ = ffn(cfg, p, x)
    x = L.apply_norm(cfg, x, params["final_norm"])
    return _logits(x[:, 0], _head_of(cfg, params)), cache
