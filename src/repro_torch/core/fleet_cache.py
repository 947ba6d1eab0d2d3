"""Per-device set-associative node cache of the mesh plane and its policy.

:class:`DexCache` holds one cache per virtual device (leading ``Dev``
axis).  :func:`cached_fetch_level` is one level of the version-checked
descent: probe, remote-fetch the misses, admit the fetched rows FIFO within
their set.  :func:`leaf_admit` rolls the §5.4 leaf-admission dice under a
:class:`CachePolicy`:

* :func:`uniform_policy` (or ``None``): every device rolls the same dice;
* :func:`divergent_policy`: the ``n_memory`` devices of a route row
  specialise on disjoint memory columns.  A device scales its admission
  percent by ``admit_bias[dev, col]`` (``col`` owns the leaf's subtree; its
  own column boosted, the others damped) and by its share of its route
  demand (:func:`demand_boost`), and folds a per-device salt into the dice;
  up to ``peek_budget`` leaf misses a batch whose subtree another column
  owns are not fetched but peeked: the engine sends them as ``MSG_PEEK``
  records in its fused round, and the owning column's device answers from
  its own cache, version-checked (:func:`peer_answer`), else by its block
  walk.

A policy is built for the whole mesh; on the rank backend each function
reads the rows of the rank's block of devices.

:func:`rt_accept` is the fence check of a route-table guess and
:func:`invalidate_nodes` the version bump of a repartition install.

The cache planes are updated in place: the engine's returned state shares
them with the state it was given, which saves a copy of every plane per
level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import mesh, routing
from repro_torch.core.mesh import resolve_device
from repro_torch.core.nodes import FANOUT, KEY_MAX

#: The paper's §5.4 leaf-admission probability P_A = 0.10, in percent.
P_ADMIT_LEAF_PCT: int = 10


class DexCache(NamedTuple):
    """Per-device set-associative node cache; axis 0 is the device axis."""

    tags: torch.Tensor  # [Dev, sets, ways] int64, -1 empty
    keys: torch.Tensor  # [Dev, sets, ways, FANOUT] int64
    children: torch.Tensor  # [Dev, sets, ways, FANOUT] int32
    values: torch.Tensor  # [Dev, sets, ways, FANOUT] int64
    fifo: torch.Tensor  # [Dev, sets] int32 FIFO-within-set pointer
    ver: torch.Tensor  # [Dev, sets, ways] int32 node version at admit


def init_cache(cfg, device=None, *, n_dev=None) -> DexCache:
    """Cold caches of ``n_dev`` devices (None: every device of the mesh)."""
    device = resolve_device(device)
    d = cfg.n_devices if n_dev is None else n_dev
    s, w = cfg.cache_sets, cfg.cache_ways
    i64 = dict(dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return DexCache(
        tags=torch.full((d, s, w), -1, **i64),
        keys=torch.full((d, s, w, FANOUT), KEY_MAX, **i64),
        children=torch.zeros((d, s, w, FANOUT), **i32),
        values=torch.zeros((d, s, w, FANOUT), **i64),
        fifo=torch.zeros((d, s), **i32),
        ver=torch.zeros((d, s, w), **i32),
    )


class CachePolicy(NamedTuple):
    """Per-device cache policy, fixed when the engine is built.

    ``admit_bias`` [Dev, n_memory] float32 multiplies a device's leaf
    admission percent by the leaf's owning column; ``evict_salt`` [Dev]
    int64 is folded into its dice salt; ``peek_budget`` [Dev] int32 caps
    its peer peeks a batch (0 everywhere: no peek machinery at all);
    ``demand_beta`` caps the route-demand boost (1.0 turns it off)."""

    admit_bias: np.ndarray
    evict_salt: np.ndarray
    peek_budget: np.ndarray
    demand_beta: float = 1.0


def uniform_policy(cfg) -> CachePolicy:
    """Every device rolls the same dice and nobody peeks."""
    d = cfg.n_devices
    return CachePolicy(
        admit_bias=np.ones((d, cfg.n_memory), np.float32),
        evict_salt=np.zeros((d,), np.int64),
        peek_budget=np.zeros((d,), np.int32),
        demand_beta=1.0,
    )


def divergent_policy(
    cfg, *, col_affinity: float = 4.0, demand_beta: float = 2.0, peek_budget: int = 64
) -> CachePolicy:
    """Cooperative fleet caching: device ``dev = r * n_memory + m`` admits
    leaves of its own column ``m`` at ``col_affinity`` times the percent and
    the other columns' at ``1 / col_affinity``, salts its dice with
    ``dev + 1``, and peeks up to ``peek_budget`` leaf misses a batch."""
    d = cfg.n_devices
    bias = np.full((d, cfg.n_memory), 1.0 / col_affinity, np.float32)
    for dev in range(d):
        bias[dev, dev % cfg.n_memory] = col_affinity
    return CachePolicy(
        admit_bias=bias,
        evict_salt=np.arange(1, d + 1, dtype=np.int64),
        peek_budget=np.full((d,), peek_budget, np.int32),
        demand_beta=float(demand_beta),
    )


def is_uniform(policy: Optional[CachePolicy]) -> bool:
    """Does ``policy`` roll the uniform dice?  (A policy may still peek:
    see :func:`peeks_enabled`.)"""
    if policy is None:
        return True
    return (
        bool(np.all(np.asarray(policy.admit_bias) == 1.0))
        and bool(np.all(np.asarray(policy.evict_salt) == 0))
        and float(policy.demand_beta) == 1.0
    )


def peeks_enabled(policy: Optional[CachePolicy]) -> bool:
    """Does any device hold a peek budget?"""
    return policy is not None and bool(np.any(np.asarray(policy.peek_budget) > 0))


def demand_boost(policy: Optional[CachePolicy], cfg, demand: torch.Tensor,
                 r_lin: torch.Tensor) -> Optional[torch.Tensor]:
    """``[Dev]`` float32 admission boost from each device's own view of the
    route demand ``[Dev, n_route]``: ``clip(n_route * share of its route
    row r_lin, 1 / beta, beta)``.  None when the policy does not use it."""
    if policy is None or float(policy.demand_beta) == 1.0:
        return None
    dem = demand.float()
    total = dem[:, 0]
    for r in range(1, dem.shape[1]):  # the reference's sum, left to right
        total = total + dem[:, r]
    share = dem.gather(1, r_lin.long()[:, None])[:, 0] / torch.clamp(total, min=1.0)
    beta = float(policy.demand_beta)
    lo, hi = float(np.float32(1.0 / beta)), float(np.float32(beta))
    return torch.clamp(cfg.n_route * share, lo, hi)


def _device_rows(plane, cfg) -> np.ndarray:
    """A policy plane's rows of the devices this process holds: every row
    on the virtual mesh, the rank's block on ranks.  Whether the policy is
    uniform or peeks is read off the whole policy, so every rank runs one
    program."""
    plane = np.asarray(plane)
    if mesh.current() is None:
        return plane
    return plane[mesh.device_linear_index(cfg, "cpu").numpy()]


def device_peek_budget(policy: CachePolicy, cfg, device) -> torch.Tensor:
    """``[Dev]`` int32 peek budget of each device this process holds a
    batch."""
    rows = _device_rows(np.asarray(policy.peek_budget, np.int32), cfg)
    return torch.as_tensor(rows).to(device)


_PHI64 = 0x9E3779B97F4A7C15  # golden-ratio odd constant
_SIGN = -(2**63)


def _salt_offsets(policy: CachePolicy, cfg) -> list:
    """Each held device's ``evict_salt * 0x9E3779B97F4A7C15`` wrapped to a
    signed int64, as the reference's int64 product wraps; computed on the
    host in exact integers."""
    out = []
    for e in _device_rows(np.asarray(policy.evict_salt, np.int64), cfg).tolist():
        w = (int(e) * _PHI64) % 2**64
        out.append(w - 2**64 if w >= 2**63 else w)
    return out


def wrapping_add(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a + c`` on int64, wrapped modulo 2**64 without a signed overflow:
    operands of opposite signs cannot overflow; for operands of one sign,
    flipping ``a``'s sign bit (``x ^ -2**63`` adds 2**63 modulo 2**64) makes
    the sum one of mixed signs, and flipping its sign bit back restores
    it."""
    same = (a < 0) == (c < 0)
    x = torch.where(same, a ^ _SIGN, a) + c
    return torch.where(same, x ^ _SIGN, x)


def leaf_admit(meta, cfg, policy: Optional[CachePolicy], gid: torch.Tensor, salt,
               *, boost: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The leaf-admission dice for ``gid`` [Dev, Q] with the caller's
    access salt (op counter plus lane); row ``d`` is the ``d``-th held
    device's (on ranks: of the rank's block), with its demand ``boost[d]``.  Under a uniform policy every device rolls
    ``routing.leaf_admit_dice(gid, p_admit_leaf_pct, salt)``; otherwise
    device ``d`` rolls at
    ``round(p_admit_leaf_pct * admit_bias[d, col] * boost)`` percent (half
    to even, clipped to 1..100, in float32 as the reference), ``col`` the
    memory column owning the leaf, with its ``evict_salt`` times
    0x9E3779B97F4A7C15 added to the salt (both wrapped)."""
    if is_uniform(policy):
        return routing.leaf_admit_dice(gid, cfg.p_admit_leaf_pct, salt=salt)
    device = gid.device
    s_per = meta.n_subtrees_padded // cfg.n_memory
    col = ((gid // meta.subtree_cap) // s_per).clamp(0, cfg.n_memory - 1)
    bias = torch.as_tensor(_device_rows(np.asarray(policy.admit_bias, np.float32), cfg))
    bias = bias.to(device)
    pct = float(np.float32(cfg.p_admit_leaf_pct)) * bias.gather(1, col.long())
    if boost is not None:
        pct = pct * boost[:, None]
    pct_i = torch.clamp(torch.round(pct), 1, 100).to(torch.int32)
    off = torch.tensor(_salt_offsets(policy, cfg), dtype=torch.int64, device=device)
    salt = torch.as_tensor(salt, dtype=torch.int64, device=device).expand(gid.shape)
    salt = wrapping_add(salt, off[:, None].expand(gid.shape))
    return routing.leaf_admit_dice(gid, pct_i, salt=salt)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return mask.to(torch.uint8).argmax(-1)


def cache_probe(cache: DexCache, cfg, versions: torch.Tensor, gid: torch.Tensor):
    """Probe each device's cache for ``gid`` [Dev, Q].  A tag match is a hit
    only while the entry's admit-time version equals the node's current
    version.  Returns ``(hit, keys_row, children_row, values_row, set_idx,
    present)``; ``present`` marks a tag match regardless of version."""
    set_idx = routing.umod(routing.hash64(gid), cfg.cache_sets)
    d = torch.arange(gid.shape[0], device=gid.device)[:, None]
    tagged = cache.tags[d, set_idx] == gid[..., None]
    cur = versions.gather(1, gid.clamp(0, versions.shape[1] - 1))
    eq = tagged & (cache.ver[d, set_idx] == cur[..., None])
    way = _first_true(eq)
    return (
        eq.any(-1),
        cache.keys[d, set_idx, way],
        cache.children[d, set_idx, way],
        cache.values[d, set_idx, way],
        set_idx,
        tagged.any(-1),
    )


def cache_admit(cache: DexCache, cfg, versions, gid, set_idx, admit, rows_k,
                rows_c, rows_v) -> DexCache:
    """FIFO-within-set insertion of fetched rows, stamped with the node's
    current version; a row whose tag is present (a version-stale copy) is
    refreshed in place without advancing the FIFO.  Updates ``cache`` in
    place and returns it.

    Two admitting lanes can land on one (set, way): different gids of one
    set read the same FIFO pointer.  The last lane wins every plane, as in
    the reference's sequential scatter; the FIFO pointer counts every
    admitting lane."""
    n_dev, q = gid.shape
    sets, ways = cfg.cache_sets, cfg.cache_ways
    dev = gid.device
    d = torch.arange(n_dev, device=dev)[:, None]
    tagged = cache.tags[d, set_idx] == gid[..., None]
    present = tagged.any(-1)
    fway = cache.fifo[d, set_idx].long() % ways
    way = torch.where(present, _first_true(tagged), fway)
    n_slots = n_dev * sets * ways
    slot = torch.where(admit, (d * sets + set_idx) * ways + way, n_slots)
    lane = (d * q + torch.arange(q, device=dev)).expand(n_dev, q)
    last = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, slot.reshape(-1), lane.reshape(-1), "amax")
    win = (admit & (last[slot] == lane)).reshape(-1)
    dst = slot.reshape(-1)[win]
    src = lane.reshape(-1)[win]
    cur = versions.gather(1, gid.clamp(0, versions.shape[1] - 1))
    cache.tags.view(-1)[dst] = gid.reshape(-1)[src]
    cache.keys.view(-1, FANOUT)[dst] = rows_k.reshape(-1, FANOUT)[src]
    cache.children.view(-1, FANOUT)[dst] = rows_c.reshape(-1, FANOUT)[src]
    cache.values.view(-1, FANOUT)[dst] = rows_v.reshape(-1, FANOUT)[src]
    cache.ver.view(-1)[dst] = cur.reshape(-1)[src]
    bump = torch.where(admit & ~present, d * sets + set_idx, n_dev * sets)
    adds = torch.zeros(n_dev * sets + 1, dtype=torch.int32, device=dev)
    ones = torch.ones(n_dev * q, dtype=torch.int32, device=dev)
    adds.scatter_add_(0, bump.reshape(-1), ones)
    cache.fifo.add_(adds[:-1].view(n_dev, sets))
    return cache


def cached_fetch_level(pool, meta, cfg, cache: DexCache, versions, gid, want,
                       admit_ok, peek_elig=None, peek_budget=None):
    """One level of the cached traversal: probe, remote-fetch the misses,
    admit the fetched rows where ``admit_ok`` (or a stale copy is present).

    With ``peek_elig`` [Dev, Q], a device's first ``peek_budget[d]`` missing
    lanes of ``peek_elig`` (in its own lane order) are peeked: they fetch
    and admit nothing here, and their rows come back KEY_MAX.  Returns
    ``(rows_k, rows_c, rows_v, hit, miss, shed, n_msgs [Dev], cache,
    peeked)``; ``peeked`` is None without ``peek_elig``."""
    hit, ck, cc, cv, set_idx, present = cache_probe(cache, cfg, versions, gid)
    hit = hit & want
    miss = want & ~hit
    peeked = None
    fetch_miss = miss
    if peek_elig is not None:
        cand = miss & peek_elig
        # each device ranks its own lanes
        rank = torch.cumsum(cand.to(torch.int32), 1) - 1
        peeked = cand & (rank < peek_budget[:, None])
        fetch_miss = miss & ~peeked
    fk, fc, fv, shed, n_msgs = routing.fetch_rows(pool, meta, cfg, gid, fetch_miss)
    h = hit[..., None]
    rows_k = torch.where(h, ck, fk)
    rows_c = torch.where(h, cc, fc)
    rows_v = torch.where(h, cv, fv)
    cache = cache_admit(
        cache,
        cfg,
        versions,
        gid,
        set_idx,
        fetch_miss & (admit_ok | present) & ~shed,
        rows_k,
        rows_c,
        rows_v,
    )
    return rows_k, rows_c, rows_v, hit, miss, shed, n_msgs, cache, peeked


def rt_accept(
    meta,
    rt_keys: torch.Tensor,
    rt_hi: torch.Tensor,
    rt_sub: torch.Tensor,
    rt_local: torch.Tensor,
    rt_ver: torch.Tensor,
    versions: torch.Tensor,
    idx: torch.Tensor,
    subtree: torch.Tensor,
    keys: torch.Tensor,
    eligible: torch.Tensor,
):
    """Fence check of a route-table guess ``idx`` [Dev, Q]
    (``routing.rt_predict``).  A guess is made for an ``eligible`` lane whose
    entry is live (``rt_ver >= 0``); it is accepted only when the key lies in
    the entry's trained fence range ``[rt_keys, rt_hi)``, the predicted
    subtree equals the top walk's ``subtree``, and the leaf's current
    version on the lane's device (``versions`` [Dev, n]) still equals the
    stamp taken at training: any write, split or repartition move bumps it.
    Returns ``(guess, accept, pred_gid)``; a rejected guess
    (``guess & ~accept``) is a mispredict and takes the full descent."""
    idx = idx.long()
    tver = rt_ver[idx]
    sub = rt_sub[idx].long()
    pred_gid = meta.node_gid(sub, rt_local[idx].long())
    gsafe = pred_gid.clamp(0, versions.shape[1] - 1)
    guess = eligible & (tver >= 0)
    accept = (
        guess
        & (keys >= rt_keys[idx])
        & (keys < rt_hi[idx])
        & (sub == subtree)
        & (versions.gather(1, gsafe) == tver)
    )
    return guess, accept, pred_gid


def peer_answer(cache: DexCache, cfg, versions: torch.Tensor, gid: torch.Tensor,
                key: torch.Tensor, want: torch.Tensor):
    """The owner's half of a ``MSG_PEEK``: device ``d`` probes its own cache
    for the leaf ``gid[d]`` [Dev, N] a sibling asked about, version-checked
    like any probe, so a stale row fails and the caller walks its block.
    Returns ``(peer_hit, found, value)``; ``found`` and ``value`` mean
    something only under ``peer_hit``."""
    hit, rows_k, _, rows_v, _, _ = cache_probe(
        cache, cfg, versions, torch.where(want, gid, 0)
    )
    peer_hit = hit & want
    eq = (rows_k == key[..., None]) & peer_hit[..., None]
    return peer_hit, eq.any(-1), torch.where(eq, rows_v, 0).sum(-1)


def invalidate_nodes(versions: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """``versions`` [Dev, n] with every distinct node of ``gids`` bumped by
    one on every device (a gid listed twice bumps once, as the reference's
    ``bump[gids] = 1`` does).  Every device's version-checked probe then
    rejects its cached copy of a bumped node.  Returns a new tensor."""
    bump = torch.zeros(versions.shape[1], dtype=versions.dtype, device=versions.device)
    bump[gids.to(versions.device).long()] = 1
    return versions + bump
