"""The split-TF32 forward kernel's design, on the CPU.

``flash_attention.cu``'s ``mma::flash_kernel`` (every float32 call, and
bfloat16 at head_dim 16 and 32) runs both products on
``mma.sync.m16n8k8`` TF32 with fragments read from shared memory and from
its own score accumulator.  It cannot run here, so this file holds what can
be held without a card, with the tile sizes parsed from the source:

- the fragment maps, with the key permutation inside each k8 step of P v,
  give S = q k^T and P v;
- the fragment reads are free of bank conflicts at the padded row strides;
- the grid and the KV-tile walk cover every visible (query, key) pair once,
  with windows and ragged lengths, heaviest query tiles first, and the
  unmasked fast path is taken only where every pair is visible;
- a NumPy model of the kernel's arithmetic (TF32 operands truncated by
  masking to 0xFFFFE000, float32 split into hi and lo, three products a
  split product, each tensor-core sum truncated to float32, the score
  accumulator added into a float32 sum every CHAIN k8 steps, each tile's
  P v on zeroed accumulators folded into O) stays within 1e-4 per row of
  ``causal_attention_plain`` at reduced train shapes: the CPU's prediction
  of the card's row errors.

The kernel itself is held against the plain version on the card by
``tests/test_torch_flash_attention.py``'s card-only tests and by
``chip_smoke.py``.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import HEAD_DIMS, causal_attention_plain

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# (dtype, head_dim) of every split-TF32 instantiation.
ROUTE_CASES = [(dt, hd) for dt in (torch.float32, torch.bfloat16) for hd in HEAD_DIMS
               if fa_mod.route(dt, hd) == "tf32-mma"]


def _source():
    return (fa_mod.build.CSRC_DIR / "flash_attention.cu").read_text()


def _mma_source():
    src = _source()
    return src[src.index("namespace mma {"):src.index("}  // namespace mma")]


def _flat(src):
    return " ".join(src.split())


def _constants():
    """BQ, CHAIN, the KV tile rule and the d split (warps that share a row
    group's d) of ``mma::``, from the source."""
    src = _mma_source()
    bq = int(re.search(r"constexpr int BQ = (\d+);", src).group(1))
    chain = int(re.search(r"constexpr int CHAIN = (\d+);", src).group(1))
    at, small, large = map(int, re.search(r"return HD <= (\d+) \? (\d+) : (\d+);", src).groups())
    split_at, split, one = map(int, re.search(r"d_split\(\) \{ return HD >= (\d+) \? (\d+) : (\d+);", src).groups())
    assert "static constexpr int THREADS = 128 * WD;" in src
    wd = lambda hd: split if hd >= split_at else one  # noqa: E731
    return {"bq": bq, "chain": chain, "kv_tile": lambda hd: small if hd <= at else large, "wd": wd,
            "threads": lambda hd: 128 * wd(hd)}


def _row_stride(hd, elem):
    """``mma::Smem::SA``: rows padded by 16 bytes."""
    assert "static constexpr int SA = HD + 16 / static_cast<int>(sizeof(T));" in _mma_source()
    return hd + 16 // elem


def test_source_is_one_split_tf32_kernel_beside_wgmma():
    """Two forward kernels: ``tc::flash_kernel`` and the split-TF32
    ``mma::flash_kernel`` (mma.sync through tf32.cuh, cp.async copies);
    every route case instantiates the latter."""
    src, mma = _source(), _mma_source()
    assert '#include "tf32.cuh"' in src
    assert len(re.findall(r"^flash_kernel\(", src, flags=re.M)) == 2
    assert "tf32::mma(" in mma and "to_tf32<X>(" in mma and "tf32::cp_async16(" in mma
    header = _flat((fa_mod.build.CSRC_DIR / "tf32.cuh").read_text())
    assert "void to_tf32(float x, uint32_t& hi, uint32_t& lo)" in header and "split(x, hi, lo);" in header
    assert "wgmma" not in mma and "__shfl_xor_sync(0xffffffffu, mx, 1)" in mma
    c = _constants()
    for hd in HEAD_DIMS:
        assert c["bq"] == 16 * c["threads"](hd) // 32 // c["wd"](hd), "a row group of 16 rows a warp (pair)"
    assert c["wd"](256) == 2 and all(c["wd"](hd) == 1 for hd in HEAD_DIMS if hd < 256)
    assert {(dt, hd) for dt, hd in ROUTE_CASES} == (
        {(torch.float32, hd) for hd in HEAD_DIMS} | {(torch.bfloat16, 16), (torch.bfloat16, 32)})


# --------------------------------------------------------------------------
# Fragments of mma.sync.m16n8k8 (TF32): lane = 4 g + t4.
# A (16 x 8): a0 = A[g][t4], a1 = A[g + 8][t4], a2 = A[g][t4 + 4], a3 = A[g + 8][t4 + 4]
# B (8 x 8, k x n): b0 = B[t4][g], b1 = B[t4 + 4][g]
# C (16 x 8): c0 = C[g][2 t4], c1 = C[g][2 t4 + 1], c2 = C[g + 8][2 t4], c3 = C[g + 8][2 t4 + 1]
# --------------------------------------------------------------------------
LANES = [divmod(lane, 4) for lane in range(32)]


def _mma(c, a, b):
    """c[lane] += the product of fragments a[lane], b[lane] (float64)."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane, (g, t4) in enumerate(LANES):
        A[g, t4], A[g + 8, t4], A[g, t4 + 4], A[g + 8, t4 + 4] = a[lane]
        B[t4, g], B[t4 + 4, g] = b[lane]
    C = A @ B
    for lane, (g, t4) in enumerate(LANES):
        c[lane] += (C[g, 2 * t4], C[g, 2 * t4 + 1], C[g + 8, 2 * t4], C[g + 8, 2 * t4 + 1])


def _gather(frags, rows, cols):
    """The warp's C fragments (one per n8 tile) as a rows x cols matrix."""
    out = np.zeros((rows, cols))
    for j, c in enumerate(frags):
        for lane, (g, t4) in enumerate(LANES):
            out[g, 8 * j + 2 * t4:8 * j + 2 * t4 + 2] = c[lane][:2]
            out[g + 8, 8 * j + 2 * t4:8 * j + 2 * t4 + 2] = c[lane][2:]
    return out


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_fragment_maps_give_s_and_p_v(hd):
    """One row group's 16 query rows against a KV tile, as its warps (one,
    or two splitting d) compute it: q k^T over each warp's columns with the
    source's reads (q[g][d_off + 8 kk + t4] and its +8 rows, +4 columns;
    k[8 j + g][d_off + 8 kk + t4], + 4), the warps' partial scores added;
    then P v over the warp's output columns with P's A fragment taken from
    the S accumulator as (c0, c2, c1, c3) and v read at [8 j + 2 t4][d_off +
    8 i + g] and the row after: inside each k8 step the k index t4 is key
    2 t4 and t4 + 4 is key 2 t4 + 1 on both sides, so the product is P v."""
    mma = _flat(_mma_source())
    assert "const float pa[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};" in mma
    assert "const T* vr = vs + 2 * t4 * SA + d_off + g;" in mma
    assert "ld(vr + 8 * j * SA + 8 * (i0 + i))" in mma and "ld(vr + (8 * j + 1) * SA + 8 * (i0 + i))" in mma
    assert "const T* kr = ks + g * SA + d_off + t4;" in mma
    assert "ld(kr + 8 * j * SA + 8 * kk)" in mma and "ld(kr + 8 * j * SA + 8 * kk + 4)" in mma
    assert "const int d_off = WD > 1 ? (warp / 4) * (HD / WD) : 0;" in mma
    assert "sc[j][e] += other[(4 * j + e) * 32];" in mma
    c = _constants()
    bk, wd = c["kv_tile"](hd), c["wd"](hd)
    dw = hd // wd
    rng = np.random.default_rng(hd)
    q, k, v = rng.standard_normal((16, hd)), rng.standard_normal((bk, hd)), rng.standard_normal((bk, hd))
    partial = []
    for d_off in range(0, hd, dw):
        s = [np.zeros((32, 4)) for _ in range(bk // 8)]
        for kk in range(dw // 8):
            col = d_off + 8 * kk
            a = [(q[g, col + t4], q[g + 8, col + t4], q[g, col + t4 + 4], q[g + 8, col + t4 + 4]) for g, t4 in LANES]
            for j in range(bk // 8):
                _mma(s[j], a, [(k[8 * j + g, col + t4], k[8 * j + g, col + t4 + 4]) for g, t4 in LANES])
        partial.append(s)
    s = [sum(p[j] for p in partial) for j in range(bk // 8)]
    np.testing.assert_allclose(_gather(s, 16, bk), q @ k.T, rtol=1e-12, atol=1e-12)
    o = np.zeros((16, hd))
    for d_off in range(0, hd, dw):
        frags = [np.zeros((32, 4)) for _ in range(dw // 8)]
        for j in range(bk // 8):
            a = [(s[j][lane][0], s[j][lane][2], s[j][lane][1], s[j][lane][3]) for lane in range(32)]
            for i in range(dw // 8):
                _mma(frags[i], a, [(v[8 * j + 2 * t4, d_off + 8 * i + g], v[8 * j + 2 * t4 + 1, d_off + 8 * i + g])
                                   for g, t4 in LANES])
        o[:, d_off:d_off + dw] = _gather(frags, 16, dw)
    np.testing.assert_allclose(o, (q @ k.T) @ v, rtol=1e-11, atol=1e-10)


def _banks(words):
    """The largest number of distinct 4-byte words one bank serves."""
    per_bank = {}
    for w in words:
        per_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("dtype,hd", ROUTE_CASES)
def test_fragment_reads_are_free_of_bank_conflicts(dtype, hd):
    """At the padded row stride the warp's [g][t4] reads of q and k (and
    their +4 columns, +8 rows) and the [2 t4][g], [2 t4 + 1][g] reads of v
    touch each bank once (two bfloat16 lanes may share a word)."""
    elem = torch.empty((), dtype=dtype).element_size()
    sa = _row_stride(hd, elem)
    mma = _flat(_mma_source())
    assert "const T* qr = reinterpret_cast<const T*>(smem) + (16 * rg + g) * SA + d_off + t4;" in mma
    c = _constants()
    for d_off in range(0, hd, hd // c["wd"](hd)):
        for dr, dc in ((0, 0), (0, 4), (8, 0), (8, 4)):
            assert _banks({((g + dr) * sa + d_off + t4 + dc) * elem // 4 for g, t4 in LANES}) == 1, (dr, dc)
        for dr in (0, 1):
            assert _banks({((2 * t4 + dr) * sa + d_off + g) * elem // 4 for g, t4 in LANES}) == 1, dr
    # The partial scores of a d split: [warp][element][lane] floats, one
    # word a lane.
    assert "float* mine = xs + warp * 32 * 4 * NK + lane;" in mma and "mine[(4 * j + e) * 32] = sc[j][e];" in mma


@pytest.mark.parametrize("dtype,hd", ROUTE_CASES)
def test_shared_memory_fits_and_is_16_byte_aligned(dtype, hd):
    """``mma::Smem``: the q tile and two (k, v) stages within the 227 KB a
    block may take, every row and tile on a 16-byte boundary (cp.async);
    the source's note states the sizes."""
    elem = torch.empty((), dtype=dtype).element_size()
    c = _constants()
    sa, bk = _row_stride(hd, elem), c["kv_tile"](hd)
    q_bytes, kv_bytes = c["bq"] * sa * elem, bk * sa * elem
    scores = c["threads"](hd) * bk // 2 * 4 if c["wd"](hd) > 1 else 0
    total = q_bytes + 4 * kv_bytes + scores
    assert "static constexpr int BYTES = XS + (WD > 1 ? THREADS * BK / 2 * 4 : 0);" in _mma_source()
    assert sa * elem % 16 == 0 and q_bytes % 16 == 0 and kv_bytes % 16 == 0
    assert total <= 232448
    assert f"{total:,}" in _flat(_source()), "the note's shared-memory sizes are stale"


def _walk(s_len, window, bq, bk):
    """The kernel's KV tiles per query tile: k_begin, k_end as the source
    computes them."""
    flat = _flat(_mma_source())
    assert "const int k_end = min(q0 + BQ, s_len);" in flat
    assert "const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;" in flat
    tiles = {}
    for q0 in range(0, s_len, bq):
        k_end = min(q0 + bq, s_len)
        k_begin = (max(0, q0 - window + 1) // bk) * bk if window > 0 else 0
        tiles[q0] = list(range(k_begin, k_end, bk))
    return tiles


def _visible(qp, kp, s_len, window):
    return kp <= qp < s_len and (window <= 0 or qp - kp < window)


@pytest.mark.parametrize("s_len,window", [(1, 0), (37, 0), (37, 5), (200, 64), (300, 17), (600, 512), (129, 128),
                                          (2047, 512), (256, 1), (100, 99)])
@pytest.mark.parametrize("hd", [64, 256])
def test_tile_walk_covers_every_visible_pair_once(s_len, window, hd):
    """Every visible (query, key) pair lies in exactly one tile the walk
    processes for its query's tile, every processed tile holds a visible
    pair of its query tile, and where the source takes the unmasked
    softmax (``k0 + BK - 1 <= w0``, keys within S, the window spanning the
    warp's 16 rows) every pair of the warp's rows is visible."""
    c = _constants()
    bq, bk = c["bq"], c["kv_tile"](hd)
    assert ("if (k0 + BK - 1 <= w0 && k0 + BK <= s_len && (window <= 0 || w0 + 15 - k0 < window))"
            in _flat(_mma_source()))
    walk = _walk(s_len, window, bq, bk)
    seen = {}
    for q0, tiles in walk.items():
        for k0 in tiles:
            pairs = [(qp, kp) for qp in range(q0, min(q0 + bq, s_len)) for kp in range(k0, min(k0 + bk, s_len))
                     if _visible(qp, kp, s_len, window)]
            assert pairs, (q0, k0)
            for p in pairs:
                seen[p] = seen.get(p, 0) + 1
            for w0 in range(q0, q0 + bq, 16):
                if k0 + bk - 1 <= w0 and k0 + bk <= s_len and (window <= 0 or w0 + 15 - k0 < window):
                    assert all(_visible(qp, kp, s_len, window) or qp >= s_len
                               for qp in range(w0, w0 + 16) for kp in range(k0, k0 + bk))
    want = {(qp, kp) for qp in range(s_len) for kp in range(s_len) if _visible(qp, kp, s_len, window)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("b,s_len,h", [(2, 2048, 16), (2, 2048, 4), (1, 37, 3), (3, 1, 2)])
def test_grid_takes_every_query_tile_once_heaviest_first(b, s_len, h):
    """Block i takes query tile n_qt - 1 - i / (B H) of (batch, head)
    i % (B H): each (batch, head, query tile) once, later (heavier) tiles
    first."""
    flat = _flat(_mma_source())
    assert "const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;" in flat
    assert "const int bh = static_cast<int>(blockIdx.x) % n_bh;" in flat
    assert "static_cast<long long>((s + BQ - 1) / BQ) * b * h;" in flat
    bq = _constants()["bq"]
    n_qt = -(-s_len // bq)
    blocks = [((n_qt - 1 - i // (b * h)) * bq, i % (b * h)) for i in range(n_qt * b * h)]
    assert sorted(blocks) == sorted((q0, bh) for q0 in range(0, s_len, bq) for bh in range(b * h))
    assert [q0 for q0, _ in blocks] == sorted((q0 for q0, _ in blocks), reverse=True)


# --------------------------------------------------------------------------
# The kernel's arithmetic in NumPy
# --------------------------------------------------------------------------
def _tf32(x):
    """TF32 operand of float32 x: the tensor core reads its top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(np.asarray(x, np.float32) - hi)


def _rz32(x):
    """float64 to float32, truncated toward zero (the tensor core's sum)."""
    bits = np.asarray(x, np.float64).view(np.uint64) & ~np.uint64((1 << 29) - 1)
    return bits.view(np.float64).astype(np.float32)


def _mma_sum(c, a, b):
    """c + a b over one k8 step: exact products, the sum cut to float32."""
    return _rz32(c.astype(np.float64) + np.matmul(a.astype(np.float64), b.astype(np.float64)))


def kernel_model(q, k, v, scale, window, bq, bk, chain, wd):
    """float32 q, k, v (B, S, H / KV, hd) numpy -> the split-TF32 kernel's
    output, with its tiles, its walk and its order of sums (``wd`` warps
    splitting d, their partial scores added), every (batch, head) of a
    query tile at once."""
    b, s_len, h, hd = q.shape
    kv = k.shape[2]
    out = np.zeros_like(q)
    pad = -(-s_len // bq) * bq + bk
    qp_, kp_, vp_ = (np.zeros((b, pad, x.shape[2], hd), np.float32) for x in (q, k, v))
    qp_[:, :s_len], kp_[:, :s_len], vp_[:, :s_len] = q, k, v
    qh_all = qp_.transpose(0, 2, 1, 3)                                         # (B, H, pad, hd)
    kh_all = np.repeat(kp_, h // kv, axis=2).transpose(0, 2, 1, 3)
    vh_all = np.repeat(vp_, h // kv, axis=2).transpose(0, 2, 1, 3)
    scale2 = np.float32(np.float32(scale) * np.float32(LOG2E))
    for q0, tiles in _walk(s_len, window, bq, bk).items():
        qh, ql = _split(qh_all[:, :, q0:q0 + bq])
        m = np.full((b, h, bq), NEG_INF, np.float32)
        l = np.zeros((b, h, bq), np.float32)
        o = np.zeros((b, h, bq, hd), np.float32)
        rows = np.arange(q0, q0 + bq)
        for k0 in tiles:
            kh, kl = _split(kh_all[:, :, k0:k0 + bk])
            vh, vl = _split(vh_all[:, :, k0:k0 + bk])
            parts = []
            for w0 in range(0, hd, hd // wd):
                part = np.zeros((b, h, bq, bk), np.float32)
                for d0 in range(w0, w0 + hd // wd, 8 * chain):
                    c = np.zeros_like(part)
                    for d in range(d0, min(d0 + 8 * chain, w0 + hd // wd), 8):
                        sl = slice(d, d + 8)
                        for a_, b_ in ((ql, kh), (qh, kl), (qh, kh)):
                            c = _mma_sum(c, a_[..., sl], np.swapaxes(b_[..., sl], -1, -2))
                    part = (part + c).astype(np.float32)
                parts.append(part)
            sc = parts[0] if wd == 1 else (parts[0] + parts[1]).astype(np.float32)
            keys = np.arange(k0, k0 + bk)
            vis = (keys[None, :] <= rows[:, None]) & (keys[None, :] < s_len)
            if window > 0:
                vis &= rows[:, None] - keys[None, :] < window
            x = np.where(vis, sc * scale2, np.float32(NEG_INF)).astype(np.float32)
            m_new = np.maximum(m, x.max(-1))
            corr = np.exp2(m - m_new).astype(np.float32)
            p = np.exp2(x - m_new[..., None]).astype(np.float32)
            l = (l * corr + p.sum(-1, dtype=np.float32)).astype(np.float32)
            m = m_new
            ph, pl = _split(p)
            acc = np.zeros_like(o)
            for j in range(0, bk, 8):
                sl = slice(j, j + 8)
                for a_, b_ in ((pl, vh), (ph, vl), (ph, vh)):
                    acc = _mma_sum(acc, a_[..., sl], b_[..., sl, :])
            o = (o * corr[..., None] + acc).astype(np.float32)
        res = o / np.maximum(l, np.float32(1e-30))[..., None]
        n = min(bq, s_len - q0)
        out[:, q0:q0 + n] = res[:, :, :n].transpose(0, 2, 1, 3)
    return out


def _row_err(got, want):
    d = np.linalg.norm(got.astype(np.float64) - want.astype(np.float64), axis=-1)
    return float((d / np.maximum(np.linalg.norm(want.astype(np.float64), axis=-1), 1e-30)).max())


@pytest.mark.parametrize(
    "b,s_len,h,kv,hd,window",
    [
        (1, 256, 2, 2, 64, 0),    # qwen1.5-0.5b's head_dim, global, reduced length and heads
        (1, 200, 4, 1, 256, 64),  # gemma3-1b's, GQA 4, windowed, ragged
        (1, 160, 4, 1, 256, 0),   # gemma3-1b's global layers
    ],
)
def test_numpy_model_of_the_arithmetic_is_within_the_row_tolerance(b, s_len, h, kv, hd, window):
    """The model of the kernel's arithmetic against the float32 plain
    version, each output row's error norm over the row's norm, within
    chip_smoke.py's FLASH_ROW_TOL for float32 (1e-4); against float64 it
    reads at the float32 plain version's own rounding, not above 1e-5."""
    c = _constants()
    rng = np.random.default_rng(s_len + hd)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((b, s_len, h, hd), (b, s_len, kv, hd), (b, s_len, kv, hd)))
    scale = hd ** -0.5
    got = kernel_model(q, k, v, scale, window, c["bq"], c["kv_tile"](hd), c["chain"], c["wd"](hd))
    plain = causal_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale=scale, window=window).numpy()
    exact = causal_attention_plain(*(torch.from_numpy(a).double() for a in (q, k, v)), scale=scale,
                                   window=window).numpy()
    assert _row_err(got, plain) <= 1e-4
    assert _row_err(got, exact) <= 1e-5


def test_model_without_the_split_breaks_the_tolerance():
    """The same model on unsplit TF32 operands (hi only) misses 1e-4 by
    far: the split, not the tolerance, is what holds the rows."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 128, 2, 64), dtype=np.float32) for _ in range(3))
    c = _constants()
    plain = causal_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.125).numpy()
    global _split
    split = _split
    try:
        _split = lambda x: (_tf32(x), np.zeros_like(np.asarray(x, np.float32)))  # noqa: E731
        unsplit = kernel_model(q, k, v, 0.125, 0, c["bq"], c["kv_tile"](64), c["chain"], c["wd"](64))
    finally:
        _split = split
    assert _row_err(unsplit, plain) > 1e-4
