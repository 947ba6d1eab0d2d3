"""Plain PyTorch versions of the port's kernels.

Each function computes exactly what its CUDA kernel computes, with tensor
operations.  A kernel's wrapper (``kernels/ops.py``) takes the plain version
for tensors that lie on the CPU; ``chip_smoke.py`` holds each kernel to its
plain version on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.nodes import KEY_MAX


def node_search_ref(
    rows: torch.Tensor,
    queries: torch.Tensor,
    values: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """In-node lower bound plus exact match, per lane.

    ``rows`` [B, F] int64, ``queries`` [B] int64, ``values`` [B, F] int64 or
    None.  Returns ``slot = max(#(row <= q) - 1, 0)`` as int32, ``found``
    (some key equals q) and ``value``, the int64 sum of the values at the
    matching slots (0 when ``values`` is None)."""
    q = queries[:, None]
    cnt = (rows <= q).sum(-1)
    slot = torch.clamp(cnt - 1, min=0).to(torch.int32)
    eq = rows == q
    found = eq.any(-1)
    if values is None:
        value = torch.zeros_like(queries)
    else:
        value = torch.where(eq, values, 0).sum(-1)
    return slot, found, value


def node_search_prefix_ref(
    prefix: torch.Tensor,
    nbits: torch.Tensor,
    suffix: torch.Tensor,
    rows: torch.Tensor,
    queries: torch.Tensor,
) -> torch.Tensor:
    """Lower bound over prefix-compressed rows, per lane.

    ``prefix`` [B] int64 (low ``nbits`` zeroed), ``nbits`` [B] int32 (-1 =
    incompressible, else at most 30), ``suffix`` [B, F] int32
    (``0x7FFFFFFF`` padding), ``rows`` [B, F] int64 the canonical rows,
    ``queries`` [B] int64.  A compressible row's keys share the bits above
    ``nbits``, so ``key <= q`` is the prefix compare of ``q``'s masked high
    bits, with the int32 suffix compare breaking a tie; an incompressible
    row counts its canonical keys.  Returns ``slot = max(count - 1, 0)``
    (int32), equal to ``node_search_ref``'s slot for every query below
    KEY_MAX."""
    q = queries
    good = nbits >= 0
    nb = nbits.clamp(min=0).long()
    mask = torch.bitwise_left_shift(torch.ones_like(q), nb) - 1
    q_suf = (q & mask).to(torch.int32)
    q_pref = q & ~mask
    nreal = (suffix != 0x7FFFFFFF).sum(-1)
    cnt_sfx = (suffix <= q_suf[:, None]).sum(-1)
    cnt_c = torch.where(
        q_pref == prefix, cnt_sfx, torch.where(prefix < q_pref, nreal, 0)
    )
    cnt_f = (rows <= q[:, None]).sum(-1)
    cnt = torch.where(good, cnt_c, cnt_f)
    return torch.clamp(cnt - 1, min=0).to(torch.int32)


def subtree_walk_ref(
    pool_keys: torch.Tensor,
    pool_children: torch.Tensor,
    pool_values: torch.Tensor,
    subtree: torch.Tensor,
    queries: torch.Tensor,
    *,
    levels: int,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query walks subtree block ``subtree[i]`` of the pool from its
    root (local id 0) down ``levels`` levels; returns ``(found, value,
    local)``, ``local`` [B] int32 being the leaf's block-local id as read
    from its parent's child slot (0 when ``levels == 1``).

    ``pool_keys``/``pool_values`` [S, C, F] int64, ``pool_children``
    [S, C, F] int32, ``subtree`` [B] int32, ``queries`` [B] int64.  A
    negative subtree or child id counts from the end, as numpy indexing
    does; ``local`` keeps the id unwrapped, as the reference engine's walk
    does.  ``active`` [B] bool, where given, names the lanes that walk;
    the others return ``(False, 0, 0)``."""
    if active is not None:
        found = torch.zeros_like(active)
        value = torch.zeros_like(queries)
        local = torch.zeros_like(subtree)
        sel = torch.nonzero(active)[:, 0]
        found[sel], value[sel], local[sel] = subtree_walk_ref(
            pool_keys, pool_children, pool_values, subtree[sel], queries[sel],
            levels=levels,
        )
        return found, value, local
    st = subtree.long()
    q = queries[:, None]
    local = torch.zeros_like(st)
    for _ in range(levels - 1):
        slot, _, _ = node_search_ref(pool_keys[st, local], queries)
        local = pool_children[st, local, slot.long()].long()
    eq = pool_keys[st, local] == q
    found = eq.any(-1)
    value = torch.where(eq, pool_values[st, local], 0).sum(-1)
    return found, value, local.to(torch.int32)


def leaf_write_ref(
    rows_k: torch.Tensor,
    rows_v: torch.Tensor,
    upd_slot: torch.Tensor,
    upd_val: torch.Tensor,
    ins_key: torch.Tensor,
    ins_val: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Staged writes applied to sorted leaf rows, as
    ``repro.kernels.ref.leaf_write_ref`` computes them.

    ``rows_k``/``rows_v`` [Q, F] int64 (KEY_MAX padding), ``upd_slot``
    [Q, S] int32 (-1 inactive), ``upd_val``/``ins_key``/``ins_val`` [Q, S]
    int64 (``ins_key`` KEY_MAX inactive).  Updates land at their slot (the
    values of several updates of one slot add up), then the active inserts
    merge into the row by a stable sort of the ``[Q, F + S]`` concatenation.
    Active insert keys must be ascending, distinct from each other and from
    the row's keys, and fit in the row's slack.  Returns ``(new_keys [Q, F],
    new_values [Q, F], new_occupancy [Q] int32)``; padding values are 0."""
    q, f = rows_k.shape
    slot = upd_slot.long()
    # a spare column takes the inactive updates
    col = torch.where((slot >= 0) & (slot < f), slot, f)
    uv = torch.zeros((q, f + 1), dtype=torch.int64, device=rows_k.device)
    uv.scatter_add_(1, col, upd_val)
    has_u = torch.zeros((q, f + 1), dtype=torch.bool, device=rows_k.device)
    has_u.scatter_(1, col, torch.ones_like(col, dtype=torch.bool))
    v1 = torch.where(has_u[:, :f], uv[:, :f], rows_v)
    act = ins_key != KEY_MAX
    merged_k = torch.cat([rows_k, torch.where(act, ins_key, KEY_MAX)], -1)
    merged_v = torch.cat(
        [torch.where(rows_k != KEY_MAX, v1, 0), torch.where(act, ins_val, 0)], -1
    )
    out_k, order = torch.sort(merged_k, dim=-1, stable=True)
    out_k = out_k[:, :f].contiguous()
    out_v = merged_v.gather(1, order[:, :f])
    out_v = torch.where(out_k != KEY_MAX, out_v, 0)
    occ = (out_k != KEY_MAX).sum(-1).to(torch.int32)
    return out_k, out_v, occ


def leaf_scan_ref(
    window_keys: torch.Tensor,
    window_values: torch.Tensor,
    start_keys: torch.Tensor,
    counts: torch.Tensor,
    *,
    max_count: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``counts[b]`` records with key >= ``start_keys[b]`` taken from
    each lane's leaf window, as ``repro.kernels.ref.leaf_scan_ref`` computes
    them.

    ``window_keys``/``window_values`` [B, W] int64 are consecutive leaf rows
    (KEY_MAX padding), ``start_keys`` [B] int64, ``counts`` [B] int32
    (clipped to ``[0, max_count]``).  The selected records keep their window
    order (a stable sort by selection rank compacts them to the front).
    Returns ``(keys [B, max_count] KEY_MAX-padded, values [B, max_count]
    0-padded, taken [B] int32)``; ``max_count`` must not exceed ``W``."""
    counts = counts.to(torch.int32).clamp(0, max_count)
    w = window_keys.shape[1]
    mask = (window_keys != KEY_MAX) & (window_keys >= start_keys[:, None])
    rank = torch.cumsum(mask.to(torch.int32), -1)
    sel = mask & (rank <= counts[:, None])
    taken = sel.sum(-1).to(torch.int32)
    order = torch.sort(torch.where(sel, rank, w + 1), dim=-1, stable=True).indices
    order = order[:, :max_count]
    out_k = torch.where(sel, window_keys, KEY_MAX).gather(1, order)
    out_v = torch.where(sel, window_values, 0).gather(1, order)
    return out_k, out_v, taken


def leaf_split_ref(
    rows_k: torch.Tensor,
    rows_v: torch.Tensor,
    ins_key: torch.Tensor,
    ins_val: torch.Tensor,
):
    """Staged inserts merged into sorted leaf rows, a row cut in two where
    the merge overflows it, as ``repro.kernels.ref.leaf_split_ref`` computes
    it.

    ``rows_k``/``rows_v`` [Q, F] int64 (KEY_MAX padding), ``ins_key``/
    ``ins_val`` [Q, S] int64 (``ins_key`` KEY_MAX inactive; active keys
    distinct from each other and from the row's keys).  A stable sort of the
    ``[Q, F + S]`` concatenation merges them; a row whose merged count ``m``
    exceeds F is cut at ``m // 2`` (the left row keeps the lower half), any
    other comes back whole as the left row.  Returns ``(left_k, left_v,
    right_k, right_v [Q, F], occ_l, occ_r [Q] int32, sep [Q] int64,
    did_split [Q] int32)``; ``sep`` is the right row's first key, KEY_MAX
    where the row did not split; padding values are 0."""
    f = rows_k.shape[1]
    act = ins_key != KEY_MAX
    merged_k = torch.cat([rows_k, torch.where(act, ins_key, KEY_MAX)], -1)
    merged_v = torch.cat(
        [torch.where(rows_k != KEY_MAX, rows_v, 0), torch.where(act, ins_val, 0)], -1
    )
    mk, order = torch.sort(merged_k, dim=-1, stable=True)
    mv = merged_v.gather(1, order)
    m = (mk != KEY_MAX).sum(-1).to(torch.int32)
    split = m > f
    left_n = torch.where(split, m // 2, m)
    col = torch.arange(mk.shape[1], device=rows_k.device)[None, :]
    in_left = col < left_n[:, None]
    lk = torch.where(in_left, mk, KEY_MAX)[:, :f].contiguous()
    lv = torch.where(in_left & (mk != KEY_MAX), mv, 0)[:, :f].contiguous()
    idx = torch.clamp(col[:, :f] + left_n[:, None], 0, mk.shape[1] - 1)
    rk_full = mk.gather(1, idx)
    rv_full = mv.gather(1, idx)
    in_right = split[:, None] & (col[:, :f] < (m - left_n)[:, None])
    rk = torch.where(in_right, rk_full, KEY_MAX)
    rv = torch.where(in_right & (rk_full != KEY_MAX), rv_full, 0)
    occ_l = (lk != KEY_MAX).sum(-1).to(torch.int32)
    occ_r = (rk != KEY_MAX).sum(-1).to(torch.int32)
    sep = torch.where(split, rk[:, 0], KEY_MAX)
    return lk, lv, rk, rv, occ_l, occ_r, sep, split.to(torch.int32)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    with_lse: bool = False,
):
    """Blocked prefill attention's function, unblocked.

    ``q`` [B, H, Sq, D]; ``k``, ``v`` [B, HKV, Sk, D] with H % HKV == 0
    (query head ``h`` reads kv head ``h // (H // HKV)``).  In f32 (float64
    stays float64); causal masks key ``j`` from query ``i`` where ``j > i +
    Sk - Sq``.  Returns q's dtype.  A row that no key may reach is NaN here
    (the kernel writes 0 there).  ``with_lse`` also returns the natural
    log-sum-exp of each row's scaled, masked logits, ``lse [B, H, Sq]`` f32
    (``-inf`` where no key is reached): what the backward needs to rebuild
    the probabilities."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct) * scale
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        s = s.masked_fill(~_causal_mask(sq, sk, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    if not with_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)
    return o, lse


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """``[Sq, Sk]`` bool, True where query ``i`` may see key ``j``: ``j <= i
    + Sk - Sq``."""
    rows = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return rows >= torch.arange(sk, device=device)[None, :]


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of ``flash_attention_ref``'s output, by the formulas
    the backward kernel computes (not by autograd).

    ``q``, ``o``, ``do`` [B, H, Sq, D]; ``k``, ``v`` [B, HKV, Sk, D]; ``lse``
    [B, H, Sq] the forward's natural log-sum-exp.  In f32 (float64 stays
    float64), one kv head at a time so that no [B, H, Sq, Sk] tensor is
    held: ``P = exp(S scale - lse)`` with ``S = Q K^T``, ``dV = P^T dO``,
    ``dP = dO V^T``, ``Delta = rowsum(dO * O)``, ``dS = P * (dP - Delta)``,
    ``dQ = dS K scale``, ``dK = dS^T Q scale``; dK and dV summed over each kv
    head's G query heads.  A row no key reaches (``lse = -inf``) has P = 0
    and Delta = 0, so its dQ is 0 and it adds nothing to dK and dV, whatever
    its ``o`` holds.  Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    dq = torch.empty(q.shape, dtype=ct, device=q.device)
    dk = torch.empty(k.shape, dtype=ct, device=q.device)
    dv = torch.empty(v.shape, dtype=ct, device=q.device)
    keep = _causal_mask(sq, sk, q.device) if causal else None
    for n in range(hkv):
        hs = slice(n * group, (n + 1) * group)
        qf, of, dof = (t[:, hs].to(ct) for t in (q, o, do))  # [B, G, Sq, D]
        kf, vf = k[:, n].to(ct), v[:, n].to(ct)  # [B, Sk, D]
        none = torch.isinf(lse[:, hs]).unsqueeze(-1)  # rows no key reaches
        s = torch.einsum("bgqd,bkd->bgqk", qf, kf) * scale
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        p = torch.exp(s - lse[:, hs].to(ct).unsqueeze(-1).masked_fill(none, 0.0))
        delta = (dof * of).sum(-1, keepdim=True).masked_fill(none, 0.0)
        ds = p * (torch.einsum("bgqd,bkd->bgqk", dof, vf) - delta)
        dv[:, n] = torch.einsum("bgqk,bgqd->bkd", p, dof)
        dk[:, n] = torch.einsum("bgqk,bgqd->bkd", ds, qf) * scale
        dq[:, hs] = torch.einsum("bgqk,bkd->bgqd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    with_lse: bool = False,
):
    """Decode attention over KV pages through a page table, one query token
    per request.

    ``q`` [B, H, D]; ``k_pages``, ``v_pages`` [P, page, HKV, D];
    ``page_table`` [B, pages_per_req] int32; ``seq_lens`` [B] int32.  Token
    ``t`` of request ``b`` lies at ``k_pages[page_table[b, t // page], t %
    page]``; tokens at or past ``seq_lens[b]`` are masked.  In f32; returns
    q's dtype.  A request with ``seq_len = 0`` is NaN here (the kernel
    writes 0 there).  ``with_lse`` also returns the log-sum-exp of the
    masked logits, ``lse [B, H]`` f32 (``-inf`` at ``seq_len = 0``): the
    history's weight in the decode step's blend."""
    b, h, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    group = h // hkv
    ppr = page_table.shape[1]
    scale = 1.0 / math.sqrt(d)
    tbl = page_table.long()
    k = k_pages[tbl].reshape(b, ppr * page, hkv, d)
    v = v_pages[tbl].reshape(b, ppr * page, hkv, d)
    pos = torch.arange(ppr * page, device=q.device)[None, :]
    valid = pos < seq_lens[:, None]
    qf = q.float().reshape(b, hkv, group, d) * scale
    s = torch.einsum("bngd,bsnd->bngs", qf, k.float())
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngs,bsnd->bngd", p, v.float())
    o = o.reshape(b, h, d).to(q.dtype)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h)


def mamba_scan_ref(
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    x: torch.Tensor,
    *,
    save_every: int = 0,
):
    """Selective scan with diagonal ``A``, a step at a time.

    ``delta`` [B, L, D] (post-softplus), ``A`` [D, N] (negative), ``Bmat``
    and ``C`` [B, L, N], ``x`` [B, L, D]; all cast to f32 (float64 stays
    float64, for ``gradcheck``).  Per step ``h = exp(delta_t * A) * h +
    (delta_t * x_t) * B_t`` from ``h = 0``, and ``y_t = <h, C_t>``.  Returns
    ``(y [B, L, D], h_last [B, D, N])``, both in that dtype; the state is
    one [B, D, N] tensor, never [B, L, D, N].  With ``save_every`` also the
    state before every ``save_every``-th step, ``[B, ceil(L / save_every),
    D, N]`` f32: the states the backward kernel restarts from."""
    ct = _scan_dtype(delta)
    delta, A, Bmat, C, x = (t.to(ct) for t in (delta, A, Bmat, C, x))
    b, l, d = delta.shape
    h = torch.zeros((b, d, A.shape[1]), dtype=ct, device=delta.device)
    y = torch.empty((b, l, d), dtype=ct, device=delta.device)
    states = None
    if save_every:
        states = torch.empty((b, -(-l // save_every), d, A.shape[1]), dtype=torch.float32,
                             device=delta.device)
    for t in range(l):
        if states is not None and t % save_every == 0:
            states[:, t // save_every] = h
        dt = delta[:, t, :, None]
        h = torch.exp(dt * A) * h + (dt * x[:, t, :, None]) * Bmat[:, t, None, :]
        y[:, t] = (h * C[:, t, None, :]).sum(-1)
    return (y, h) if states is None else (y, h, states)


def _scan_dtype(delta: torch.Tensor) -> torch.dtype:
    return torch.float64 if delta.dtype == torch.float64 else torch.float32


def mamba_scan_bwd_ref(
    delta: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    x: torch.Tensor,
    dy: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``mamba_scan_ref``'s outputs for ``dy`` [B, L, D]
    (and ``dh_last`` [B, D, N], the final state's, or none), written out as
    the reverse recurrence the backward kernel runs (not by autograd).

    With ``a_t = exp(delta_t A)`` and ``g_t`` the gradient of the state
    ``h_t``: ``g_t = dy_t C_t + a_{t+1} g_{t+1}`` from the last step back
    (``g_L = dy_L C_L + dh_last``); ``dC_t = sum_d dy_t h_t``, ``dB_t =
    sum_d g_t delta_t x_t``, ``dx_t = delta_t sum_n g_t B_t``, ``ddelta_t =
    sum_n g_t (A a_t h_{t-1} + x_t B_t)``, ``dA = sum_{b, t} g_t a_t h_{t-1}
    delta_t``.  Every state is kept ([L + 1, B, D, N]), so ``h_{t-1}`` is
    read, never recovered from ``h_t``.  In f32 (float64 stays float64).
    Returns ``(ddelta [B, L, D], dA [D, N], dB, dC [B, L, N], dx [B, L,
    D])``, all in that dtype."""
    ct = _scan_dtype(delta)
    delta, A, Bmat, C, x, dy = (t.to(ct) for t in (delta, A, Bmat, C, x, dy))
    b, l, d = delta.shape
    n = A.shape[1]
    dev = delta.device
    hs = torch.zeros((l + 1, b, d, n), dtype=ct, device=dev)
    for t in range(l):
        dt = delta[:, t, :, None]
        hs[t + 1] = torch.exp(dt * A) * hs[t] + (dt * x[:, t, :, None]) * Bmat[:, t, None, :]
    carry = torch.zeros((b, d, n), dtype=ct, device=dev) if dh_last is None else dh_last.to(ct)
    ddelta, dx = (torch.empty((b, l, d), dtype=ct, device=dev) for _ in range(2))
    dB, dC = (torch.empty((b, l, n), dtype=ct, device=dev) for _ in range(2))
    dA = torch.zeros((d, n), dtype=ct, device=dev)
    for t in reversed(range(l)):
        dt, xt, dyt = delta[:, t, :, None], x[:, t, :, None], dy[:, t, :, None]
        bt, cc = Bmat[:, t, None, :], C[:, t, None, :]
        a = torch.exp(dt * A)
        g = dyt * cc + carry
        ah = a * hs[t]
        dC[:, t] = (dyt * hs[t + 1]).sum(1)
        dB[:, t] = (g * (dt * xt)).sum(1)
        dx[:, t] = delta[:, t] * (g * bt).sum(-1)
        ddelta[:, t] = (g * (A * ah + xt * bt)).sum(-1)
        dA += (g * ah * dt).sum(0)
        carry = a * g
    return ddelta, dA, dB, dC, dx
