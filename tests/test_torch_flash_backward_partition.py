"""The backward's split-TF32 route (every float32 call, bfloat16 at
head_dim 16 and 32): its plan and fragments, on the CPU.

``flash_attention_bwd.cu``'s dK/dV kernel walks a work list that
``kernels/flash_attention.py::dkdv_work`` builds in plain Python, here at
the split-TF32 route's tile rows; its products run on ``mma.sync.m16n8k8``
with fragments read from shared memory.  Neither runs here, so this file
holds what can be held without a card:

- the work list covers every visible (key tile, query tile, head) step once
  and no invisible one, keeps its items within the cap, heaviest first,
  and at the train paths' shapes gives no item more than the call's steps
  over the card's 132 SMs;
- a model of the decomposition (each item's partial dk, dv with the plain
  math, summed per key tile in slot order) equals
  ``causal_attention_bwd_plain``;
- a model of the mma fragments, with the index maps the source uses
  (``rows_by_rows``; ``rows_by_cols`` with the k index permuted inside each
  k8 step), gives the products they stand for;
- the source dispatches every head_dim, runs this route's products on
  ``mma.sync`` TF32 and the bfloat16 route's on ``wgmma``, and has no
  atomics.

The wgmma route's plan and fragments are held in
``tests/test_torch_flash_backward_tc.py``.

The kernel itself is held against the plain version by the card-only tests
in ``tests/test_torch_flash_backward.py`` and by ``chip_smoke.py``.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (
    DKDV_ITEM_FIELDS,
    HEAD_DIMS,
    MIN_ITEM_STEPS,
    NUM_SMS,
    bwd_tile_rows,
    causal_attention_bwd_plain,
    causal_attention_plain,
    dkdv_splits,
    dkdv_work,
)

# (B, S, H, KV, hd, window) of the train paths' calls: qwen1.5-0.5b, and
# gemma3-1b's windowed and global layers.
TRAIN_SHAPES = [(2, 2048, 16, 16, 64, 0), (2, 2048, 4, 1, 256, 512), (2, 2048, 4, 1, 256, 0)]
# Causal and windowed, ragged S, groups of 1, 4 and 8, both tile sizes.
PLAN_SHAPES = [
    (1, 45, 8, 8, 32, 0), (2, 77, 4, 1, 64, 16), (1, 300, 8, 1, 16, 299), (2, 600, 4, 1, 256, 512),
    (1, 2047, 8, 2, 96, 512), (2, 1000, 8, 1, 128, 0), (1, 1, 4, 4, 256, 0), (1, 33, 4, 1, 256, 0),
    (2, 2048, 4, 1, 256, 0), (1, 4096, 8, 1, 64, 0), (1, 512, 8, 2, 32, 16),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on a few cores: two intra-op threads
    for this file's torch ops keep it from starving the wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _steps(items):
    f = {name: i for i, name in enumerate(DKDV_ITEM_FIELDS)}
    return (items[:, f["head1"]] - items[:, f["head0"]]) * (items[:, f["qtile1"]] - items[:, f["qtile0"]])


def _visible_steps(b, s, h, kv, rows, window):
    """Every (bkv, key tile, query tile, head in group) with a visible
    (query, key) pair, by brute force over positions."""
    pos = np.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    tiles = -(-s // rows)
    seen = {(kt, qt) for kt in range(tiles) for qt in range(tiles)
            if mask[qt * rows:(qt + 1) * rows, kt * rows:(kt + 1) * rows].any()}
    return {(bkv, kt, qt, g) for bkv in range(b * kv) for kt, qt in seen for g in range(h // kv)}


def _cap(items):
    return max(MIN_ITEM_STEPS, int(_steps(items).sum()) // NUM_SMS)


@pytest.mark.parametrize("rows", [None, 16, 48])
@pytest.mark.parametrize("shape", PLAN_SHAPES + TRAIN_SHAPES)
def test_work_list_covers_every_visible_step_once(shape, rows):
    """At the kernel's tile rows and at others."""
    b, s, h, kv, hd, window = shape
    rows = rows or bwd_tile_rows(hd, torch.float32)
    items = dkdv_work(b, s, h, kv, rows, window)
    assert items.dtype == np.int32 and items.shape[1] == len(DKDV_ITEM_FIELDS)
    got = [(bkv, kt, qt, g) for bkv, kt, h0, h1, t0, t1, _ in items.tolist()
           for qt in range(t0, t1) for g in range(h0, h1)]
    assert len(got) == len(set(got))
    assert set(got) == _visible_steps(b, s, h, kv, rows, window)


@pytest.mark.parametrize("shape", PLAN_SHAPES + TRAIN_SHAPES)
def test_work_list_is_capped_heaviest_first_and_numbers_its_cuts(shape):
    b, s, h, kv, hd, window = shape
    items = dkdv_work(b, s, h, kv, bwd_tile_rows(hd, torch.float32), window)
    steps = _steps(items)
    assert (steps >= 1).all()
    assert steps.max() <= _cap(items)
    assert (np.diff(steps) <= 0).all(), "items must be ordered heaviest first"
    # A key tile is one item with slot -1, or several with consecutive
    # slots in query-tile (then head) order.
    by_tile = {}
    for bkv, kt, h0, h1, t0, t1, slot in items.tolist():
        by_tile.setdefault((bkv, kt), []).append((slot, t0, h0))
    slots = []
    for tile in by_tile.values():
        if len(tile) == 1:
            assert tile[0][0] == -1
            continue
        tile.sort()
        assert all(slot >= 0 for slot, *_ in tile)
        assert [slot for slot, *_ in tile] == list(range(tile[0][0], tile[0][0] + len(tile)))
        assert [(t0, h0) for _, t0, h0 in tile] == sorted((t0, h0) for _, t0, h0 in tile)
        slots += [slot for slot, *_ in tile]
    assert sorted(slots) == list(range(len(slots)))
    splits = dkdv_splits(items)
    assert splits.dtype == np.int32
    assert sorted(map(tuple, splits.tolist())) == sorted(
        (bkv, kt, min(s for s, *_ in t), len(t)) for (bkv, kt), t in by_tile.items() if len(t) > 1)


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=["qwen", "gemma-window", "gemma-global"])
def test_longest_item_is_within_the_mean_work_per_sm(shape):
    """At the train paths' shapes no item holds more than the call's steps
    over 132 SMs; at gemma3-1b's global layers (32-row tiles: 16,640 steps,
    126.06 a SM) that is 124 against the 256 of the first key tile whole,
    and the list fills the card."""
    b, s, h, kv, hd, window = shape
    items = dkdv_work(b, s, h, kv, bwd_tile_rows(hd, torch.float32), window)
    steps = _steps(items)
    assert steps.max() <= steps.sum() / NUM_SMS
    assert len(items) >= NUM_SMS
    if shape == (2, 2048, 4, 1, 256, 0):
        assert bwd_tile_rows(hd, torch.float32) == 32 and steps.sum() == 16640 and steps.max() <= 126
    # Scratch for the cut tiles' partials: some tens of MB at most.
    slots = int(items[:, 6].max()) + 1
    assert slots * 2 * bwd_tile_rows(hd, torch.float32) * hd * 4 <= 64 * 2**20


def _decomposition(q, k, v, o, do, scale, window, rows):
    """dk, dv as the kernels build them: each item's partial sums with the
    plain math over its (query tile, head) steps, a key tile's items summed
    in slot order; dq as the plain version gives it."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    qf, kf, vf, of, dof = (a.double() for a in (q, k, v, o, do))
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf.repeat_interleave(group, dim=2)) * scale
    lse = torch.logsumexp(scores.masked_fill(~mask, -torch.inf), dim=-1)        # (B, H, S)
    delta = (dof * of).sum(-1).transpose(1, 2)                                  # (B, H, S)
    items = dkdv_work(b, s, h, kv, rows, window)
    partial = {}
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for bkv, kt, h0, h1, t0, t1, slot in items.tolist():
        bi, hk = divmod(bkv, kv)
        keys = slice(kt * rows, min(s, kt * rows + rows))
        pdk = torch.zeros((keys.stop - keys.start, hd), dtype=torch.float64)
        pdv = torch.zeros_like(pdk)
        for qt in range(t0, t1):
            queries = slice(qt * rows, min(s, qt * rows + rows))
            for g in range(h0, h1):
                hq = hk * group + g
                m = mask[queries, keys]
                sc = qf[bi, queries, hq] @ kf[bi, keys, hk].T * scale
                p = torch.exp(sc - lse[bi, hq, queries][:, None]).masked_fill(~m, 0.0)
                ds = p * (dof[bi, queries, hq] @ vf[bi, keys, hk].T - delta[bi, hq, queries][:, None])
                pdv += p.T @ dof[bi, queries, hq]
                pdk += ds.T @ qf[bi, queries, hq]
        if slot < 0:
            dk[bi, keys, hk], dv[bi, keys, hk] = pdk * scale, pdv
        else:
            partial[slot] = (bi, keys, hk, pdk, pdv)
    for bkv, kt, first, n in dkdv_splits(items).tolist():
        bi, keys, hk, sk, sv = partial[first]
        for slot in range(first + 1, first + n):
            assert partial[slot][:3] == (bi, keys, hk)
            sk, sv = sk + partial[slot][3], sv + partial[slot][4]
        dk[bi, keys, hk], dv[bi, keys, hk] = sk * scale, sv
    return dk.float(), dv.float()


@pytest.mark.parametrize("shape", [
    (1, 300, 8, 1, 16, 299), (2, 160, 8, 1, 16, 0), (1, 150, 8, 1, 64, 0), (1, 250, 8, 1, 96, 0),
    (1, 100, 8, 1, 128, 0), (1, 200, 4, 1, 256, 0), (1, 97, 8, 1, 256, 50),
])
def test_decomposition_model_equals_the_plain_backward(shape):
    """The work list's decomposition, modelled with the plain math in
    float64, equals causal_attention_bwd_plain (float32) within 1e-6 of
    each gradient's norm, where key tiles are cut (each shape here cuts
    some): every step counted once, every cut tile summed whole."""
    b, s, h, kv, hd, window = shape
    rng = np.random.default_rng(s + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32))
                   for shp in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
    scale = hd ** -0.5
    o = causal_attention_plain(q, k, v, scale=scale, window=window)
    rows = bwd_tile_rows(hd, torch.float32)
    assert (dkdv_work(b, s, h, kv, rows, window)[:, 6] >= 0).any()
    dk, dv = _decomposition(q, k, v, o, do, scale, window, rows)
    _, want_dk, want_dv = causal_attention_bwd_plain(q, k, v, o, do, scale=scale, window=window)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert float((got - want).norm() / want.norm()) <= 1e-6


# --------------------------------------------------------------------------
# Fragments of mma.sync.m16n8k8 (TF32): lane = 4 g + t4.
# A (16 x 8): a0 = A[g][t4], a1 = A[g + 8][t4], a2 = A[g][t4 + 4], a3 = A[g + 8][t4 + 4]
# B (8 x 8, k x n): b0 = B[t4][g], b1 = B[t4 + 4][g]
# C (16 x 8): c0 = C[g][2 t4], c1 = C[g][2 t4 + 1], c2 = C[g + 8][2 t4], c3 = C[g + 8][2 t4 + 1]
# --------------------------------------------------------------------------
def _mma(c, a, b):
    """c[lane] += the product of the fragments a[lane], b[lane] (numpy,
    float64), as the tensor core forms it from the fragment layout."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        A[g, t4], A[g + 8, t4], A[g, t4 + 4], A[g + 8, t4 + 4] = a[lane]
        B[t4, g], B[t4 + 4, g] = b[lane]
    C = A @ B
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        c[lane] += (C[g, 2 * t4], C[g, 2 * t4 + 1], C[g + 8, 2 * t4], C[g + 8, 2 * t4 + 1])


def _c_tile(c, m0, n0, out):
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        out[m0 + g, n0 + 2 * t4:n0 + 2 * t4 + 2] = c[lane][:2]
        out[m0 + g + 8, n0 + 2 * t4:n0 + 2 * t4 + 2] = c[lane][2:]


def _rows_by_rows(a, b, m0, n0, nt):
    """rows_by_rows: acc[j] = A[m0 + .] . B[n0 + 8 j + .] over d, with the
    source's reads (A[g][k + t4], B[g][k + t4] and their +8, +4)."""
    hd = a.shape[1]
    acc = [np.zeros((32, 4)) for _ in range(nt)]
    for k in range(0, hd, 8):
        fa = [(a[m0 + g, k + t4], a[m0 + g + 8, k + t4], a[m0 + g, k + t4 + 4], a[m0 + g + 8, k + t4 + 4])
              for g, t4 in (divmod(lane, 4) for lane in range(32))]
        for j in range(nt):
            fb = [(b[n0 + 8 * j + g, k + t4], b[n0 + 8 * j + g, k + t4 + 4])
                  for g, t4 in (divmod(lane, 4) for lane in range(32))]
            _mma(acc[j], fa, fb)
    return acc


def _rows_by_cols(p, x, m0, n0, nt):
    """rows_by_cols: acc[j] = P[m0 + .] . X[:, n0 + 8 j + .] over rows, with
    the source's reads: a = P[g][k + 2 t4], P[g + 8][k + 2 t4],
    P[g][k + 2 t4 + 1], P[g + 8][k + 2 t4 + 1] (two float2), b = X[k + 2 t4][g],
    X[k + 2 t4 + 1][g]."""
    r = p.shape[1]
    acc = [np.zeros((32, 4)) for _ in range(nt)]
    for k in range(0, r, 8):
        fa = [(p[m0 + g, k + 2 * t4], p[m0 + g + 8, k + 2 * t4], p[m0 + g, k + 2 * t4 + 1],
               p[m0 + g + 8, k + 2 * t4 + 1]) for g, t4 in (divmod(lane, 4) for lane in range(32))]
        for j in range(nt):
            fb = [(x[k + 2 * t4, n0 + 8 * j + g], x[k + 2 * t4 + 1, n0 + 8 * j + g])
                  for g, t4 in (divmod(lane, 4) for lane in range(32))]
            _mma(acc[j], fa, fb)
    return acc


@pytest.mark.parametrize("rows,cols,hd,warps_m", [(64, 64, 64, 4), (32, 32, 256, 2), (64, 32, 128, 4), (64, 64, 16, 4)])
def test_fragment_maps_give_the_products(rows, cols, hd, warps_m):
    """The warp grid of each product (WM warps down the rows, 8 / WM across)
    with the source's fragment reads and C layout gives s = a b^T over d and
    acc = p x over rows, for every tile shape the kernels instantiate."""
    rng = np.random.default_rng(rows + cols + hd)
    a, b = rng.standard_normal((rows, hd)), rng.standard_normal((cols, hd))
    p, x = rng.standard_normal((rows, cols)), rng.standard_normal((cols, hd))
    wn = 8 // warps_m
    s_got, acc_got = np.zeros((rows, cols)), np.zeros((rows, hd))
    for warp in range(8):
        m0, wi = 16 * (warp % warps_m), warp // warps_m
        n0a, n0b = wi * (cols // wn), wi * (hd // wn)
        nta, ntb = cols // (8 * wn), hd // (8 * wn)
        for j, c in enumerate(_rows_by_rows(a, b, m0, n0a, nta)):
            _c_tile(c, m0, n0a + 8 * j, s_got)
        for j, c in enumerate(_rows_by_cols(p, x, m0, n0b, ntb)):
            _c_tile(c, m0, n0b + 8 * j, acc_got)
    np.testing.assert_allclose(s_got, a @ b.T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(acc_got, p @ x, rtol=1e-12, atol=1e-12)


def _rows_by_rows_f64(a, b, m0, n0, nt):
    """rows_by_rows_f64: mma.m8n8k4 (a = A[g][t4], b = B[t4][g], c = C[g][2 t4],
    C[g][2 t4 + 1]) on the rows g and g + 8 as two m8 tiles, gathered into
    the m16n8 C layout (c0, c1 from the top tile, c2, c3 from the bottom)."""
    hd = a.shape[1]
    acc = [np.zeros((32, 4)) for _ in range(nt)]
    for k in range(0, hd, 4):
        for j in range(nt):
            for half in (0, 1):
                A, B = np.zeros((8, 4)), np.zeros((4, 8))
                for lane in range(32):
                    g, t4 = divmod(lane, 4)
                    A[g, t4] = a[m0 + 8 * half + g, k + t4]
                    B[t4, g] = b[n0 + 8 * j + g, k + t4]
                C = A @ B
                for lane in range(32):
                    g, t4 = divmod(lane, 4)
                    acc[j][lane][2 * half:2 * half + 2] += C[g, 2 * t4:2 * t4 + 2]
    return acc


@pytest.mark.parametrize("rows,cols,hd,warps_m", [(64, 64, 64, 4), (32, 32, 256, 2), (64, 32, 128, 4)])
def test_float64_fragment_map_gives_the_product(rows, cols, hd, warps_m):
    """dQ's do v^T on the FP64 tensor cores: the same warp grid and C layout
    as rows_by_rows."""
    rng = np.random.default_rng(hd)
    a, b = rng.standard_normal((rows, hd)), rng.standard_normal((cols, hd))
    wn = 8 // warps_m
    got = np.zeros((rows, cols))
    for warp in range(8):
        m0, n0 = 16 * (warp % warps_m), (warp // warps_m) * (cols // wn)
        for j, c in enumerate(_rows_by_rows_f64(a, b, m0, n0, cols // (8 * wn))):
            _c_tile(c, m0, n0 + 8 * j, got)
    np.testing.assert_allclose(got, a @ b.T, rtol=1e-12, atol=1e-12)


def _banks(words):
    """The largest number of distinct 4-byte words one bank serves."""
    per_bank = {}
    for w in words:
        per_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("elem", [4, 2])
def test_fragment_reads_are_free_of_bank_conflicts(hd, elem):
    """Rows padded by 16 bytes (the source's row_stride): the [g][t4] reads
    of rows_by_rows and the [2 t4][g] reads of rows_by_cols touch each bank
    once per warp (two bfloat16 lanes may share a word); the float2 reads
    and writes of p, ds at a stride of 8 mod 32 floats once per half-warp."""
    sa = hd + 16 // elem
    lanes = [divmod(lane, 4) for lane in range(32)]
    for rr, cc in ((lambda g, t4: g, lambda g, t4: t4), (lambda g, t4: 2 * t4, lambda g, t4: g),
                   (lambda g, t4: 2 * t4 + 1, lambda g, t4: g)):
        words = {(rr(g, t4) * sa + cc(g, t4)) * elem // 4 for g, t4 in lanes}
        assert _banks(words) == 1, (hd, elem)
    for r in (32, 64):
        sp = r + 8
        for half in (lanes[:16], lanes[16:]):
            words = [((g * sp + 2 * t4) * 4 // 4) for g, t4 in half]
            banks = [b for w in words for b in (w % 32, (w + 1) % 32)]
            assert len(set(banks)) == len(banks) == 32


def _source():
    return (fa_mod.build.CSRC_DIR / "flash_attention_bwd.cu").read_text()


def test_source_runs_split_tf32_mma_and_no_atomics():
    """The split-TF32 kernels (outside ``namespace tc``) run ``mma.sync``
    TF32 through tf32.cuh, the bfloat16 route's (``tc::``) ``wgmma`` through
    wgmma.cuh, and neither the source nor its headers use atomics."""
    src = _source()
    header = (fa_mod.build.CSRC_DIR / "tf32.cuh").read_text()
    wgmma = (fa_mod.build.CSRC_DIR / "wgmma.cuh").read_text()
    assert '#include "tf32.cuh"' in src and '#include "tf32.cuh"' in (fa_mod.build.CSRC_DIR / "wkv6.cu").read_text()
    assert '#include "wgmma.cuh"' in src
    assert re.search(r"mma\.sync\.aligned\.m16n8k8\.row\.col\.f32\.tf32\.tf32\.f32", header)
    split, tc = src[:src.index("namespace tc {")], src[src.index("namespace tc {"):]
    assert "tf32::split" in split and "tf32::mma(" in split and "cp_async16" in split and "wgmma_" not in split
    assert "wgmma_ss<" in tc and "wgmma_rs<" in tc and "tf32::mma" not in tc
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in wgmma
    for text in (src, header, wgmma):
        assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.global", text)
    small, large = map(int, re.search(r"value = HD <= 96 \? (\d+) : (\d+);", src).groups())
    assert all(bwd_tile_rows(hd, torch.float32) == (small if hd <= 96 else large) for hd in HEAD_DIMS)
    assert f"ITEM_FIELDS = {len(DKDV_ITEM_FIELDS)};" in src
