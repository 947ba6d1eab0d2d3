"""Per-device set-associative node cache of the mesh plane.

:class:`DexCache` holds one cache per virtual device (leading ``Dev``
axis).  :func:`cached_fetch_level` is one level of the version-checked
descent: probe, remote-fetch the misses, admit the fetched rows FIFO within
their set.  Only the uniform policy (every device rolls the same §5.4
admission dice) is ported.  :func:`rt_accept` is the fence check of a
route-table guess and :func:`invalidate_nodes` the version bump of a
repartition install.

The cache planes are updated in place: the engine's returned state shares
them with the state it was given, which saves a copy of every plane per
level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import routing
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


def init_cache(cfg, device=None) -> DexCache:
    device = resolve_device(device)
    d, s, w = cfg.n_devices, cfg.cache_sets, cfg.cache_ways
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
    """Per-device cache policy (see ``repro.core.fleet_cache.CachePolicy``)."""

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


def is_uniform(policy: Optional[CachePolicy]) -> bool:
    """Does ``policy`` reduce to the uniform dice with no peer peeks?"""
    if policy is None:
        return True
    return (
        bool(np.all(np.asarray(policy.admit_bias) == 1.0))
        and bool(np.all(np.asarray(policy.evict_salt) == 0))
        and float(policy.demand_beta) == 1.0
        and not bool(np.any(np.asarray(policy.peek_budget) > 0))
    )


def leaf_admit(cfg, policy: Optional[CachePolicy], gid, salt):
    """The leaf-admission dice (uniform policy)."""
    if not is_uniform(policy):
        raise NotImplementedError("divergent cache policies are not ported yet")
    return routing.leaf_admit_dice(gid, cfg.p_admit_leaf_pct, salt=salt)


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
                       admit_ok):
    """One level of the cached traversal: probe, remote-fetch the misses,
    admit the fetched rows where ``admit_ok`` (or a stale copy is present).
    Returns ``(rows_k, rows_c, rows_v, hit, miss, shed, n_msgs [Dev],
    cache)``."""
    hit, ck, cc, cv, set_idx, present = cache_probe(cache, cfg, versions, gid)
    hit = hit & want
    miss = want & ~hit
    fk, fc, fv, shed, n_msgs = routing.fetch_rows(pool, meta, cfg, gid, miss)
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
        miss & (admit_ok | present) & ~shed,
        rows_k,
        rows_c,
        rows_v,
    )
    return rows_k, rows_c, rows_v, hit, miss, shed, n_msgs, cache


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


def invalidate_nodes(versions: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """``versions`` [Dev, n] with every distinct node of ``gids`` bumped by
    one on every device (a gid listed twice bumps once, as the reference's
    ``bump[gids] = 1`` does).  Every device's version-checked probe then
    rejects its cached copy of a bumped node.  Returns a new tensor."""
    bump = torch.zeros(versions.shape[1], dtype=versions.dtype, device=versions.device)
    bump[gids.to(versions.device).long()] = 1
    return versions + bump
