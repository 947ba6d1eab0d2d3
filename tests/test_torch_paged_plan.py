"""The bf16 ``paged_attention`` kernel's launch plan and its decomposition,
mirrored in Python, on the CPU; the log-sum-exp the kernel now returns; and
groups of 16 query heads a kv head.

The plan (``kernels/paged_attention.py::plan``) is what the CUDA entry
checks: for every attention config in ``configs/`` at page 16 and tables
of 1, 4, 36 and 257 pages it must fit in the 232,448 bytes of shared
memory a CTA may use, and its splits must cover the table's positions
exactly once; its constants and instantiations are read out of
``csrc/paged_attention.cu``.

``split_merge`` computes the kernel's splits, warps, tiles, base-2 online
softmax and merges in torch.  Tolerances: against the plain version in
float32, 1e-6 absolute plus 1e-6 relative (two f32 computations over up to
576 positions, in another order and base: a few f32 ulps of outputs up to
about 3); in bf16, the kernel's 2e-2 gate.  The plain version's ``lse`` is
held to the reference decode step's own formula within 1e-5 (f32), and at
G = 16 the plain version to the reference's oracle and its Pallas kernel in
interpret mode with tests/test_torch_attention.py's tolerances (float32
3e-5, bfloat16 2e-2)."""

import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SOURCE = pathlib.Path(pa.__file__).resolve().parents[1] / "csrc" / "paged_attention.cu"
ATTENTION = sorted(n for n in ARCHS if not get_config(n).ssm)


def constant(name):
    m = re.search(rf"constexpr (?:int|float) {name} = (\d+)f?;", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def instantiations():
    """(KD, NT) of every bf16 kernel the source builds."""
    return {
        (int(a), int(b))
        for a, b in re.findall(r"^\s*DEX_PAGED_PLAN\((\d+), (\d+)\)\s*$",
                               SOURCE.read_text(), re.M)
    }


def test_constants_match_the_source():
    assert constant("kTileTokens") == pa.TILE_TOKENS
    assert constant("kRowPad") == pa.ROW_PAD
    assert constant("kMaxWarps") == pa.MAX_WARPS
    assert constant("kSmemLimit") == pa.SMEM_LIMIT == 232_448
    assert instantiations() == {(dp // 16, nt) for dp in pa.PADDED_D for nt in (1, 2)}


def check_plan(p, b, hkv, g, d, page, ppr):
    ctx = ppr * page
    assert p.split_tokens % pa.TILE_TOKENS == 0 and p.split_tokens > 0
    # the splits cover [0, ctx) exactly once, none of them empty
    cover = np.zeros(ctx, np.int64)
    for s in range(p.splits):
        lo, hi = s * p.split_tokens, min((s + 1) * p.split_tokens, ctx)
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert 1 <= p.warps <= pa.MAX_WARPS
    assert p.warps * pa.TILE_TOKENS == p.split_tokens  # a warp a tile
    assert p.padded_d in pa.PADDED_D and d <= p.padded_d < d + 64
    assert p.n_tiles == (1 if g <= 8 else 2)
    assert (p.padded_d // 16, p.n_tiles) in instantiations()
    assert p.smem_bytes == pa.split_smem_bytes(p.padded_d, p.n_tiles, p.warps)
    assert p.smem_bytes <= pa.SMEM_LIMIT
    # q, then every staged tile's K and V rows, each 16-byte aligned
    assert p.smem_bytes >= 2 * (p.padded_d + pa.ROW_PAD) * (8 * p.n_tiles + 2 * p.split_tokens)
    assert (2 * (p.padded_d + pa.ROW_PAD)) % 16 == 0


@pytest.mark.parametrize("b", [1, 64, 512])
@pytest.mark.parametrize("ppr", [1, 4, 36, 257])
@pytest.mark.parametrize("arch", ATTENTION)
def test_plan_of_every_attention_config_fits_and_covers(arch, ppr, b):
    cfg = get_config(arch)
    hkv, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    check_plan(pa.plan(b, hkv, g, d, 16, ppr, torch.bfloat16), b, hkv, g, d, 16, ppr)


@pytest.mark.parametrize("page", [1, 4, 8, 12, 16, 32, 128, 512])
@pytest.mark.parametrize("d", [8, 80, 136, 256])
@pytest.mark.parametrize("g", [1, 16])
def test_plan_at_other_pages_and_head_dims(page, d, g):
    for ppr in (1, 3, 36):
        check_plan(pa.plan(6, 2, g, d, page, ppr, torch.bfloat16), 6, 2, g, d, page, ppr)


def test_serving_plan():
    """minitron-4b's decode call: 64 requests x 8 kv heads over 36 pages of
    16: 9 splits of 4 pages, 4,608 CTAs of 4 warps."""
    p = pa.plan(64, 8, 3, 128, 16, 36, torch.bfloat16)
    assert (p.splits, p.split_tokens, p.warps) == (9, 64, 4)
    assert p.split_tokens / 16 == 4  # pages a split
    assert 64 * 8 * p.splits == 4_608
    assert p.smem_bytes == 36_992
    # a short table is one split of its own length, in tiles of 16
    short = pa.plan(64, 8, 3, 128, 4, 5, torch.bfloat16)
    assert (short.splits, short.split_tokens, short.warps) == (1, 32, 2)
    f = pa.plan(64, 8, 3, 128, 16, 36, torch.float32)
    assert f.n_tiles == 0 and f.splits == 1 and f.warps == 8  # the CUDA-core walk
    assert pa.plan(5, 2, 16, 256, 16, 3, torch.float32).warps == 2  # 48 KB


def paged_case(b, h, hkv, d, page, ppr, lens, seed, dtype, v_scale=1.0):
    """A pool larger than the tables, every row random (so a stale row read
    past a length would change the answer)."""
    rng = np.random.default_rng(seed)
    n_pages = b * ppr + 5
    q = rng.standard_normal((b, h, d))
    kp = rng.standard_normal((n_pages, page, hkv, d))
    vp = rng.standard_normal((n_pages, page, hkv, d)) * v_scale
    table = rng.permutation(n_pages)[: b * ppr].reshape(b, ppr).astype(np.int32)
    return [torch.from_numpy(a).to(dtype) for a in (q, kp, vp)] + [
        torch.from_numpy(table), torch.tensor(lens, dtype=torch.int32)
    ]


def lengths(page, ppr, split):
    """0, 1, a page, a split's tokens - 1, + 0 and + 1, and the whole table."""
    return [0, 1, page, split - 1, split, split + 1, ppr * page]


def assert_lse_equal(got, want, tol):
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and bool((got[inf] == want[inf]).all())
    np.testing.assert_allclose(got[~inf].numpy(), want[~inf].numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize(
    "h,hkv,d,page,ppr",
    [(24, 8, 128, 16, 36), (6, 2, 32, 16, 9), (32, 2, 64, 4, 20), (4, 4, 80, 32, 5),
     (16, 8, 256, 16, 12)],
)
def test_split_merge_matches_plain_in_float32(h, hkv, d, page, ppr):
    p = pa.plan(7, hkv, h // hkv, d, page, ppr, torch.bfloat16)
    lens = [min(n, ppr * page) for n in lengths(page, ppr, p.split_tokens)]
    args = paged_case(7, h, hkv, d, page, ppr, lens, d + ppr, torch.float32)
    out, lse = pa.split_merge(*args)
    want, want_lse = ref.paged_attention_ref(*args, with_lse=True)
    assert bool((out[0] == 0).all())  # length 0: zeros, as the kernel writes
    np.testing.assert_allclose(out.numpy(), want.nan_to_num().numpy(), atol=1e-6, rtol=1e-6)
    inf = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), inf) and bool((lse[inf] == want_lse[inf]).all())
    np.testing.assert_allclose(lse[~inf].numpy(), want_lse[~inf].numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("v_scale", [1.0, 3.0])
def test_split_merge_precision_in_bf16(v_scale):
    """At a reduced serving shape (8 requests of 24 heads over 8 of 128, 36
    pages of 16) with outputs up to about 3 (v_scale 1) and 9 (3): the
    kernel's weights, bf16 hi + lo, stay within the 2e-2 gate and, before
    the output's rounding, within 1e-4 of the plain version in f32; hi
    alone (bf16 weights) is more than 10x further off and rounds far more
    outputs to another bf16 value: the reason for the split."""
    p = pa.plan(8, 8, 3, 128, 16, 36, torch.bfloat16)
    lens = [0, 1, 16, p.split_tokens - 1, p.split_tokens, p.split_tokens + 1, 576, 300]
    args = paged_case(8, 24, 8, 128, 16, 36, lens, 1, torch.bfloat16, v_scale)
    want = ref.paged_attention_ref(*args).float().nan_to_num()
    want_f32 = ref.paged_attention_ref(
        *[a.float() if a.is_floating_point() else a for a in args]
    ).nan_to_num()
    err, err_f32, differ = {}, {}, {}
    for parts in (1, 2):
        out, lse = pa.split_merge(*args, p_parts=parts)
        out_f32, _ = pa.split_merge(*args, p_parts=parts, out_dtype=torch.float32)
        err[parts] = float((out.float() - want).abs().max())
        err_f32[parts] = float((out_f32 - want_f32).abs().max())
        differ[parts] = float((out.float() != want).float().mean())
    assert err[2] <= 2e-2 and err_f32[2] <= 1e-4
    assert err_f32[1] > 10 * err_f32[2]
    assert differ[1] > 10 * differ[2]


def test_lse_matches_the_reference_formula():
    """The plain version's ``lse`` against the reference decode step's own
    history log-sum-exp (``repro/serve/serve_step.py``: q scaled in f32,
    the regathered pages, masked, ``jax.nn.logsumexp``), in float32."""
    b, h, hkv, d, page, ppr = 6, 12, 4, 64, 16, 5
    p = pa.plan(b, hkv, h // hkv, d, page, ppr, torch.bfloat16)
    lens = lengths(page, ppr, p.split_tokens)[:b]
    args = paged_case(b, h, hkv, d, page, ppr, lens, 3, torch.float32)
    _, lse = ref.paged_attention_ref(*args, with_lse=True)
    q, kp, _, table, sl = (jnp.asarray(a.numpy()) for a in args)
    qg = q.reshape(b, hkv, h // hkv, d).astype(jnp.float32) * (1.0 / float(np.sqrt(d)))
    kh = kp[table].reshape(b, ppr * page, hkv, d)
    sh = jnp.einsum("bngd,bsnd->bngs", qg, kh.astype(jnp.float32))
    pos_ids = jnp.arange(ppr * page)[None]
    sh = jnp.where((pos_ids < sl[:, None])[:, None, None, :], sh, -jnp.inf)
    want = torch.from_numpy(np.array(jax.nn.logsumexp(sh, axis=-1)).reshape(b, h))
    assert bool(torch.isinf(lse[0]).all())  # length 0
    assert_lse_equal(lse, want, 1e-5)


def test_validate_takes_groups_up_to_16():
    q = torch.zeros(2, 16 * 3, 32)
    kp = torch.zeros(4, 8, 3, 32)
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    pa.validate(q, kp, kp, tbl, lens)
    with pytest.raises(ValueError, match="group must be 1-16"):
        pa.validate(torch.zeros(2, 17 * 3, 32), kp, kp, tbl, lens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_16_matches_the_reference(dtype):
    """llama3-405b's group (128 heads over 8): 32 heads over 2, lengths 0,
    1, a page, partial and the whole table."""
    b, h, hkv, d, page, ppr = 5, 32, 2, 64, 16, 3
    lens = [0, 1, page, page + 3, ppr * page]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    args = paged_case(b, h, hkv, d, page, ppr, lens, 16, tdt)
    got, lse = ref.paged_attention_ref(*args, with_lse=True)
    assert got.shape == (b, h, d) and lse.shape == (b, h)
    args_j = [jnp.asarray(a.float().numpy(), jnp.float32 if dtype == "float32" else jnp.bfloat16)
              for a in args[:3]] + [jnp.asarray(a.numpy()) for a in args[3:]]
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    got_f = got.float().numpy()
    oracle = np.asarray(jnp.asarray(ref_ref.paged_attention_ref(*args_j), jnp.float32))
    np.testing.assert_allclose(got_f, oracle, atol=tol, rtol=tol)  # NaN = NaN at length 0
    pallas = np.asarray(jnp.asarray(ref_ops.paged_attention(*args_j), jnp.float32))
    np.testing.assert_allclose(np.nan_to_num(got_f), pallas, atol=tol, rtol=tol)
    # the kernel's decomposition at two n tiles of heads
    out, mlse = pa.split_merge(*args)
    np.testing.assert_allclose(out.float().numpy(), np.nan_to_num(got_f), atol=tol, rtol=tol)
    assert_lse_equal(mlse, lse, 1e-5 if dtype == "float32" else 1e-3)
    assert math.isinf(float(mlse[0, 0]))
