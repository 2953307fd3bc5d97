"""The backward's wgmma route (bfloat16 at head_dim 64, 96, 128, 256), on
the CPU.

``flash_attention_bwd.cu``'s ``tc::`` kernels run every product on
``wgmma`` with bfloat16 operands and float32 accumulators, and round p and
ds to bfloat16 before their products.  They cannot run here, so this file
holds what can be held without a card, with the layouts parsed from the
sources:

- ``bwd_route`` and ``bwd_tile_rows`` for every (dtype, head_dim), and the
  C dispatch taking the same cases;
- the dK/dV work list at the route's 64-row tiles covers every visible
  step once, within the cap, and fills the card at the production shapes;
- the fake form allocates what a launch of either route would;
- the fragment maps: a score accumulator (s^T = k q^T, or s = q k^T) turned
  into wgmma's A registers by the source's packing and multiplied by an
  MN-major tile gives p^T do, ds^T q and ds k, stored by the source's row
  and column map; lse and delta read per column of s^T;
- the descriptors of the backward's products read the chunks that
  ``load_tile`` wrote, at every tile the kernels stage;
- a model of the route's rounding (p and ds in bfloat16, float32 sums)
  stays within the card's row limit of ``causal_attention_bwd_plain`` and
  of ``jax.grad`` of the reference's ``attention_chunked`` in bfloat16;
- the sources round p and ds into A registers and keep lse in base 2, as
  the model reads them.

The kernels themselves are held against the plain version on the card by
``tests/test_torch_flash_backward.py``'s card-only tests and by
``chip_smoke.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    NUM_SMS,
    TENSOR_CORE_HEAD_DIMS,
    bwd_route,
    bwd_tile_rows,
    causal_attention_bwd,
    causal_attention_bwd_plain,
    causal_attention_plain,
    dkdv_work,
)

CSRC = fa_mod.build.CSRC_DIR
# (B, S, H, KV, hd, window) of the bf16 production train step's calls:
# qwen1.5-0.5b, and gemma3-1b's windowed and global layers.
PROD_SHAPES = [(1, 4096, 16, 16, 64, 0), (1, 4096, 4, 1, 256, 512), (1, 4096, 4, 1, 256, 0)]
# chip_smoke.py's GRAD_ROW_TOL in bfloat16, and its row floor: each row's
# error over its norm, the norm floored at 0.1 of the RMS row norm.
ROW_TOL, ROW_FLOOR = 3e-2, 0.1


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _source():
    return (CSRC / "flash_attention_bwd.cu").read_text()


def _tc_source():
    src = _source()
    return src[src.index("namespace tc {"):src.index("}  // namespace tc")]


def _flat(src):
    return " ".join(src.split())


# --------------------------------------------------------------------------
# Routes and the C dispatch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_and_tile_rows(dtype, head_dim):
    """bfloat16 at 64, 96, 128, 256 on wgmma with 64-row tiles (wgmma's M);
    the rest split TF32 with KvTile's rows (64 up to hd 96, else 32); the
    forward's route takes the same cases."""
    tc = dtype == torch.bfloat16 and head_dim in (64, 96, 128, 256)
    assert bwd_route(dtype, head_dim) == ("tensor-core" if tc else "tf32-mma")
    assert bwd_route(dtype, head_dim) == fa_mod.route(dtype, head_dim)
    assert bwd_tile_rows(head_dim, dtype) == (64 if tc or head_dim <= 96 else 32)


def _c_switches():
    """{(is_bf16, hd): the launch it returns} of the backward's C entry."""
    src = _source()
    entry = src[src.index('extern "C" int flash_attention_bwd('):src.index('extern "C" int flash_attention_bwd_smem(')]
    bf16_part = entry[entry.index("if (is_bf16) {"):]
    cut = bf16_part.index("default:")
    cases = {}
    for is_bf16, part in ((1, bf16_part[:cut]), (0, bf16_part[cut + 1:])):
        for hd, call in re.findall(r"case (\d+): return ((?:tc::)?launch<[^>]*>)", part):
            cases[is_bf16, int(hd)] = call
    return cases


def test_bwd_route_mirrors_the_c_dispatch():
    """For every (dtype, head_dim) the C entry launches the kernels that
    ``bwd_route`` names: ``tc::launch`` (wgmma) for "tensor-core", the
    split-TF32 ``launch`` of that type otherwise; the shared-memory query
    follows the same switch."""
    cases = _c_switches()
    for dtype, is_bf16, ctype in ((torch.float32, 0, "float"), (torch.bfloat16, 1, "bf16")):
        for hd in HEAD_DIMS:
            tc = bwd_route(dtype, hd) == "tensor-core"
            assert cases[is_bf16, hd] == (f"tc::launch<{hd}>" if tc else f"launch<{ctype}, {hd}>"), (dtype, hd)
    assert tuple(hd for (_, hd), call in cases.items() if call.startswith("tc::")) == TENSOR_CORE_HEAD_DIMS
    src = _source()
    smem = src[src.index('extern "C" int flash_attention_bwd_smem('):]
    for hd in TENSOR_CORE_HEAD_DIMS:
        assert f"case {hd}: return tc::smem_of<{hd}>(kernel);" in smem
    for hd in (16, 32):
        assert f"case {hd}: return smem_of<bf16, {hd}>(kernel);" in smem
    assert "TILE_ROWS = 64;" in _tc_source()


# --------------------------------------------------------------------------
# The work list at the route's tiles, and the scratch the call allocates
# --------------------------------------------------------------------------
def _visible_steps(b, s, h, kv, rows, window):
    pos = np.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    tiles = -(-s // rows)
    seen = {(kt, qt) for kt in range(tiles) for qt in range(tiles)
            if mask[qt * rows:(qt + 1) * rows, kt * rows:(kt + 1) * rows].any()}
    return {(bkv, kt, qt, g) for bkv in range(b * kv) for kt, qt in seen for g in range(h // kv)}


@pytest.mark.parametrize("shape", [
    (1, 45, 8, 8, 64, 0), (2, 77, 4, 1, 64, 16), (2, 600, 4, 1, 256, 512), (1, 2047, 8, 2, 96, 512),
    (2, 1000, 8, 1, 128, 0), (1, 1, 4, 4, 256, 0), (1, 33, 4, 1, 256, 0), (2, 2048, 4, 1, 256, 0),
] + PROD_SHAPES)
def test_work_list_at_the_wgmma_tiles_covers_every_visible_step_once(shape):
    b, s, h, kv, hd, window = shape
    rows = bwd_tile_rows(hd, torch.bfloat16)
    assert rows == 64
    items = dkdv_work(b, s, h, kv, rows, window)
    steps = (items[:, 3] - items[:, 2]) * (items[:, 5] - items[:, 4])
    got = [(bkv, kt, qt, g) for bkv, kt, h0, h1, t0, t1, _ in items.tolist()
           for qt in range(t0, t1) for g in range(h0, h1)]
    assert len(got) == len(set(got)) and set(got) == _visible_steps(b, s, h, kv, rows, window)
    assert steps.max() <= max(fa_mod.MIN_ITEM_STEPS, int(steps.sum()) // NUM_SMS)
    assert (np.diff(steps) <= 0).all()


@pytest.mark.parametrize("shape", PROD_SHAPES, ids=["qwen", "gemma-window", "gemma-global"])
def test_wgmma_work_list_fills_the_card_at_the_production_shapes(shape):
    """At the bf16 production shapes the 64-row work list has at least one
    item per SM, none above the call's steps over 132, and the cut tiles'
    float32 partials stay some tens of MB."""
    b, s, h, kv, hd, window = shape
    items = dkdv_work(b, s, h, kv, 64, window)
    steps = (items[:, 3] - items[:, 2]) * (items[:, 5] - items[:, 4])
    assert len(items) >= NUM_SMS and steps.max() <= steps.sum() / NUM_SMS
    slots = int(items[:, 6].max()) + 1
    assert slots * 2 * 64 * hd * 4 <= 64 * 2**20


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64), (torch.bfloat16, 256), (torch.bfloat16, 96),
                                      (torch.bfloat16, 32), (torch.float32, 64), (torch.float32, 256)])
def test_fake_form_allocates_what_the_launch_would(monkeypatch, dtype, hd):
    """On fake card tensors the wrapper allocates what its CUDA path hands
    the kernels: dq, dk, dv, (lse, delta) and one float32 (dk, dv) tile of
    the route's rows per slot of the work list at those rows."""
    b, s, h, kv, window = 1, 300, 4, 1, 0
    seen = []
    monkeypatch.setattr(fa_mod, "_fake_backward", lambda inputs, outputs: seen.append(outputs))
    with FakeTensorMode():
        q, o, do = (torch.empty(b, s, h, hd, dtype=dtype, device="cuda") for _ in range(3))
        k, v = (torch.empty(b, s, kv, hd, dtype=dtype, device="cuda") for _ in range(2))
        causal_attention_bwd(q, k, v, o, do, scale=hd ** -0.5, window=window)
    (outs,) = seen
    rows = bwd_tile_rows(hd, dtype)
    items = dkdv_work(b, s, h, kv, rows, window)
    slots = int(items[:, 6].max()) + 1
    assert slots > 1, "the shape must cut key tiles"
    want = [((b, s, h, hd), dtype), ((b, s, kv, hd), dtype), ((b, s, kv, hd), dtype),
            ((2, b, h, s), torch.float32), ((slots, 2, rows, hd), torch.float32)]
    assert [(tuple(t.shape), t.dtype) for t in outs] == want
    assert all(t.device.type == "cuda" for t in outs)
    assert fa_mod._dkdv_items(b, s, h, kv, rows, window)[1] == slots


# --------------------------------------------------------------------------
# wgmma's fragments (PTX ISA, m64nNk16, one warpgroup of 4 warps): thread
# t = 32 w + lane, lane = 4 g + t4.
# D (64 x N, float32): register i at row 16 w + g + 8 ((i / 2) % 2),
#   column 8 (i / 4) + 2 t4 + i % 2.
# A from registers (64 x 16, bfloat16 pairs): register j, half e at row
#   16 w + g + 8 (j % 2), column 8 (j / 2) + 2 t4 + e.
# --------------------------------------------------------------------------
def _d_map(n):
    """(thread, register) -> (row, column) of a 64 x n accumulator."""
    return {(t, i): (16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (t % 4) + i % 2)
            for t in range(128) for i in range(n // 2)}


def _a_map():
    return {(t, j, e): (16 * (t // 32) + (t % 32) // 4 + 8 * (j % 2), 8 * (j // 2) + 2 * (t % 4) + e)
            for t in range(128) for j in range(4) for e in range(2)}


def _to_a(frag, n):
    """The source's ``to_a``: A fragment of K step kk, register j = the
    pair (x[8 kk + 2 j], x[8 kk + 2 j + 1]), the first in the low half."""
    src = _tc_source()
    assert "a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);" in src
    assert "__floats2bfloat162_rn(lo, hi);   // lo in the low half" in (CSRC / "wgmma.cuh").read_text()
    return {(t, kk, j, e): frag[t][8 * kk + 2 * j + e] for t in range(128) for kk in range(n // 16)
            for j in range(4) for e in range(2)}


def _rs(a, b_tile, n):
    """wgmma RS over K = n: the A registers through the ISA's A map, times
    b_tile (n x hd, read MN-major), summed over the K steps."""
    amap = _a_map()
    out = np.zeros((64, b_tile.shape[1]))
    for kk in range(n // 16):
        a_mat = np.zeros((64, 16))
        for (t, j, e), (r, c) in amap.items():
            a_mat[r, c] = a[t, kk, j, e]
        out += a_mat @ b_tile[16 * kk:16 * kk + 16]
    return out


def _stored(acc, hd, cols):
    """The source's ``store_rows``: element (p, i) of thread t at row
    16 w + lane / 4 + 8 ((i / 2) % 2), column p COLS + 8 (i / 4) + 2 (lane % 4)
    (with i + 1 beside it)."""
    src = _flat(_tc_source())
    assert "const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);" in src
    assert "const int col = p * P::COLS + 8 * (i / 4) + 2 * (lane % 4);" in src
    out = np.zeros((64, hd))
    for p in range(hd // cols):
        for t in range(128):
            lane, warp = t % 32, t // 32
            for i in range(0, cols // 2, 2):
                row = 16 * warp + lane // 4 + 8 * ((i // 2) % 2)
                col = p * cols + 8 * (i // 4) + 2 * (lane % 4)
                out[row, col:col + 2] = acc[p][t][i:i + 2]
    return out


@pytest.mark.parametrize("hd", TENSOR_CORE_HEAD_DIMS)
@pytest.mark.parametrize("n", [64, 32])
def test_score_fragments_as_a_registers_give_the_row_contracting_products(hd, n):
    """A 64 x n score fragment (s^T of the dK/dV kernel, n = 64; s of the
    dQ kernel, n = 64, or 32 at hd 256) packed by ``to_a`` is the A operand
    of x times an n-row tile read MN-major, one wgmma per panel of COLS
    columns: the product, stored by ``store_rows``, is x @ tile."""
    rng = np.random.default_rng(hd + n)
    x = rng.standard_normal((64, n))
    tile = rng.standard_normal((n, hd))
    dmap = _d_map(n)
    frag = np.zeros((128, n // 2))
    for (t, i), (r, c) in dmap.items():
        frag[t, i] = x[r, c]
    a = np.zeros((128, n // 16, 4, 2))
    for key, val in _to_a(frag, n).items():
        a[key] = val
    cols = 64 if hd % 64 == 0 else 32
    acc = []
    for p in range(hd // cols):
        prod = _rs(a, tile[:, p * cols:(p + 1) * cols], n)
        panel = np.zeros((128, cols // 2))
        for (t, i), (r, c) in _d_map(cols).items():
            panel[t, i] = prod[r, c]
        acc.append(panel)
    np.testing.assert_allclose(_stored(acc, hd, cols), x @ tile, rtol=1e-12, atol=1e-12)


def test_statistics_are_read_per_column_of_s_t_and_per_row_of_s():
    """dK/dV: p^T = exp2(s^T scale2 - lse2[query]) with the query the
    fragment's column, the key its row; dQ: lse2 and delta of the thread's
    two rows, the key 8 (j / 4) + 2 t4 + j % 2: the ISA's D map."""
    src = _flat(_tc_source())
    assert "const int row = 16 * (static_cast<int>(threadIdx.x) % WG / 32) + lane / 4;" in src
    assert "const int c = 8 * (i / 4) + 2 * (lane % 4);" in src
    assert "const int kp = k0 + row + 8 * ((i / 2) % 2);" in src
    assert "!visible(q0 + c, kp, s_len, window)" in src and "!visible(q0 + c + 1, kp, s_len, window)" in src
    assert "const int qp0 = q0 + 16 * warp + lane / 4;" in src
    assert "const int e = (j / 2) % 2;" in src
    assert "!visible(qp0 + 8 * e, k0 + 8 * (j / 4) + col + j % 2, s_len, window)" in src
    for (t, i), (r, c) in _d_map(64).items():
        lane, warp = t % 32, t // 32
        assert (16 * warp + lane // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2) == (r, c)


# --------------------------------------------------------------------------
# Descriptors of the backward's products against load_tile's writes
# --------------------------------------------------------------------------
SWIZZLE_BYTES = {1: 128, 2: 64}


def _panel(hd):
    wide = hd % 64 == 0
    cols = 64 if wide else 32
    header = _flat((CSRC / "wgmma.cuh").read_text())
    assert "COLS = WIDE ? 64 : 32;" in header and "MODE = WIDE ? 1 : 2;" in header
    assert "((P::WIDE ? ((c % 8) ^ (r % 8)) : ((c % 4) ^ ((r >> 1) % 4))) << 4)" in header
    swz = (lambda c, r: (c % 8) ^ (r % 8)) if wide else (lambda c, r: (c % 4) ^ ((r >> 1) % 4))
    return {"cols": cols, "row": 2 * cols, "chunks": 2 * cols // 16, "atom": 16 * cols, "steps": 2 * cols // 32,
            "mode": 1 if wide else 2, "swizzle": swz}


def _load_tile(hd, rows, base):
    p = _panel(hd)
    return {(r, c): base + (c // p["chunks"]) * (rows * p["row"]) + r * p["row"] + (p["swizzle"](c, r) << 4)
            for r in range(rows) for c in range(hd // 8)}


def _hw_read(start, sbo, width, row, chunk):
    """The address wgmma reads for ``row`` (8-row groups SBO apart) and the
    16-byte ``chunk`` of that row inside one swizzle atom, per the ISA."""
    assert start % width + 16 * (chunk + 1) <= width
    addr = start + (row // 8) * sbo + (row % 8) * width + 16 * chunk
    return addr ^ (((addr >> 7) & (width // 16 - 1)) << 4)


@pytest.mark.parametrize("hd", TENSOR_CORE_HEAD_DIMS)
def test_backward_descriptors_read_the_chunks_load_tile_wrote(hd):
    """rows_by_rows (A: a 64-row tile, B: an N-row one, both K-major over
    hd) and rows_by_cols (B: a K-row tile read MN-major, one panel per
    wgmma) read, at every k16 step, the chunks load_tile put there, for
    every tile the kernels stage: 64 rows, and 32-key tiles in dQ at hd 256."""
    src = _flat(_tc_source())
    assert ("smem_desc<P::MODE>(a + (kk / P::STEPS) * (TILE_ROWS * P::ROW) + step, 16, P::ATOM), "
            "smem_desc<P::MODE>(b + (kk / P::STEPS) * (N * P::ROW) + step, 16, P::ATOM), kk > 0);") in src
    assert "smem_desc<P::MODE>(b + p * (K * P::ROW) + kk * 16 * P::ROW, P::ATOM, P::ATOM)" in src
    assert "constexpr int dq_keys() { return HD == 256 ? 32 : 64; }" in src
    p = _panel(hd)
    width = SWIZZLE_BYTES[p["mode"]]
    base = 4 * 1024
    for rows in {64, 32 if hd == 256 else 64}:
        wrote = _load_tile(hd, rows, base)
        for kk in range(hd // 16):   # K-major: rows by 16 columns of hd
            start = base + (kk // p["steps"]) * (rows * p["row"]) + (kk % p["steps"]) * 32
            for r in range(rows):
                for half in range(2):
                    assert _hw_read(start, p["atom"], width, r, half) == wrote[r, 2 * kk + half]
        for kk in range(rows // 16):   # MN-major: 16 rows by a panel's columns
            for panel in range(hd // p["cols"]):
                start = base + panel * (rows * p["row"]) + kk * 16 * p["row"]
                for r in range(16):
                    for nc in range(p["chunks"]):
                        got = _hw_read(start, p["atom"], width, r, nc)
                        assert got == wrote[16 * kk + r, panel * p["chunks"] + nc]


# --------------------------------------------------------------------------
# The route's rounding
# --------------------------------------------------------------------------
def _route_model(q, k, v, o, do, scale, window):
    """The wgmma route's arithmetic in float32: scores and dp from the
    bfloat16 inputs with float32 sums, p = exp(s - lse), delta = do . o,
    ds = p (dp - delta); p and ds rounded to bfloat16 before dv = p^T do,
    dk = ds^T q scale and dq = ds k scale; gradients stored in bfloat16."""
    b, s_len, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qf, kf, vf, of, dof = (a.float() for a in (q, k, v, o, do))
    kf, vf = kf.repeat_interleave(rep, dim=2), vf.repeat_interleave(rep, dim=2)
    pos = torch.arange(s_len)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse = torch.logsumexp(scores.masked_fill(~mask, -torch.inf), dim=-1, keepdim=True)
    p = torch.exp(scores - lse).masked_fill(~mask, 0.0)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf).reshape(b, s_len, kv, rep, hd).sum(3) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, dof).reshape(b, s_len, kv, rep, hd).sum(3)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _row_errs(got, want):
    """chip_smoke.py's grad_row_err of each gradient, the floor at 0.1 of
    the RMS row norm of the three ``want`` gradients together."""
    sq = [w.float().norm(dim=-1).square() for w in want]
    floor = ROW_FLOOR * float((sum(x.sum() for x in sq) / sum(x.numel() for x in sq)).sqrt())
    return [float(((g.float() - w.float()).norm(dim=-1) / w.float().norm(dim=-1).clamp_min(floor)).max())
            for g, w in zip(got, want)]


def _bf16_inputs(shape, seed):
    b, s, h, kv, hd, _ = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shp, dtype=np.float32) for shp in
              ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd))]
    return arrays, [torch.from_numpy(a).bfloat16() for a in arrays]


@pytest.mark.parametrize("shape", [(1, 200, 4, 1, 64, 0), (2, 130, 8, 2, 96, 17), (1, 160, 4, 4, 128, 0),
                                   (1, 150, 4, 1, 256, 64)])
def test_route_rounding_stays_within_the_row_limit_of_the_plain_backward(shape):
    """p and ds in bfloat16 cost about 2^-9 of a row: the model reads well
    inside GRAD_ROW_TOL (3e-2) against ``causal_attention_bwd_plain`` on the
    same bfloat16 inputs, as the card's kernels must."""
    _, (q, k, v, do) = _bf16_inputs(shape, seed=shape[1])
    scale, window = shape[4] ** -0.5, shape[5]
    o = causal_attention_plain(q, k, v, scale=scale, window=window)
    errs = _row_errs(_route_model(q, k, v, o, do, scale, window),
                     causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window))
    assert max(errs) <= ROW_TOL / 3, errs


@pytest.mark.parametrize("hd,kv,window", [(64, 2, 0), (256, 1, 48)])
def test_route_rounding_against_jax_grad_of_attention_chunked(hd, kv, window):
    """Against the reference's own bfloat16 gradient (XLA autodiff of
    ``attention_chunked``, which rounds the probabilities and runs its
    einsums in bfloat16): each gradient's error norm within 2e-2 of its
    norm (tests/test_torch_flash_backward.py's bfloat16 tolerance) and every
    row within GRAD_ROW_TOL."""
    shape = (1, 256, 4, kv, hd, window)
    arrays, (q, k, v, do) = _bf16_inputs(shape, seed=hd)
    scale = hd ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    pos = jnp.arange(shape[1])

    def f(q_, k_, v_):
        k_, v_ = jnp.repeat(k_, 4 // kv, axis=2), jnp.repeat(v_, 4 // kv, axis=2)
        return ref_layers.attention_chunked(q_, k_, v_, pos, pos, window, scale, q_chunk=128, kv_chunk=128)

    out, vjp = jax.vjp(f, jq, jk, jv)
    want = [torch.tensor(np.asarray(g.astype(jnp.float32))) for g in vjp(jdo)]
    o = torch.tensor(np.asarray(out.astype(jnp.float32))).bfloat16()
    got = _route_model(q, k, v, o, do, scale, window)
    for g, w in zip(got, want):
        assert float((g.float() - w).norm() / w.norm()) <= 2e-2
    assert max(_row_errs(got, want)) <= ROW_TOL


# --------------------------------------------------------------------------
# The sources
# --------------------------------------------------------------------------
def test_wgmma_route_rounds_p_and_ds_into_a_registers_and_keeps_lse_in_base_2():
    """The sources as the model above reads them: p^T, ds^T and ds reach
    their products as bfloat16 A registers (``to_a``; no shared-memory
    copy), the scores are exp2 of base-2 scores against a base-2
    log-sum-exp, and dp^T / ds^T share warpgroup 0's p^T through shared
    memory behind a named barrier at hd 128 and 256.  (Which route runs
    ``wgmma`` and which split TF32, and the absence of atomics:
    ``tests/test_torch_flash_backward_partition.py``.)"""
    tc = _flat(_tc_source())
    assert "to_a<R>(s, x);" in tc and "to_a<R>(dp, x);" in tc and "to_a<BK>(dp, x);" in tc
    assert "m[e] + log2f(l[e])" in tc and "exp2f(s[j] * scale2 - lr[e])" in tc
    assert "exp2f(s[i] * scale2 - l2.x)" in tc and "const float scale2 = scale * LOG2E;" in tc
    assert 'asm volatile("bar.arrive 1, %0;\\n" :: "n"(2 * WG) : "memory");' in tc
    assert 'asm volatile("bar.sync 1, %0;\\n" :: "n"(2 * WG) : "memory");' in tc
    assert "constexpr int dkdv_groups() { return HD >= 128 ? 2 : 1; }" in tc
