"""The port's ``causal_attention`` against the JAX package's
``ops.causal_attention`` and ``ref.attention_ref``.

On CPU tensors the port's wrapper computes its plain version; the JAX side
runs the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it.  The hand-written CUDA kernel itself is held against the plain version
by the test here that needs a card (skipped without one) and by
``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch import tracing
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import causal_attention, causal_attention_plain

TOL = {"float32": 5e-4, "bfloat16": 3e-2}   # tests/test_kernels.py::TestFlashAttention


def _inputs(b, s, h, kv, hd, dtype, seed=0):
    """The same seeded numpy q, k, v as a (jax, torch) pair of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    ]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return (
        tuple(jnp.asarray(a).astype(jdt) for a in arrays),
        tuple(torch.from_numpy(a).to(tdt) for a in arrays),
    )


def _attention_ref(q, k, v, scale, window):
    """``ref.attention_ref`` over the natural layout, KV heads repeated (as
    ``tests/test_kernels.py::_attn_expect``)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)

    def flat(a):
        return a.transpose(0, 2, 1, 3).reshape(b * h, s, hd)

    out = ref.attention_ref(flat(q), flat(k), flat(v), scale=scale, window=window)
    return out.reshape(b, h, s, hd).transpose(0, 2, 1, 3)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64, 17])
def test_causal_and_window_match_the_pallas_kernel_and_its_oracle(window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 128, 4, 2, 32, dtype)
    scale = 1.0 / np.sqrt(32)
    got = _f32(causal_attention(tq, tk, tv, scale=scale, window=window))
    pallas = _f32(ops.causal_attention(jq, jk, jv, scale=scale, window=window, block_q=32, block_k=32))
    oracle = _f32(_attention_ref(jq, jk, jv, scale, window))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,s,h,kv,hd,window",
    [
        (1, 64, 4, 1, 256, 16),   # GQA rep 4 at gemma3's head_dim, windowed
        (1, 37, 4, 2, 32, 0),     # ragged S, global
        (2, 37, 2, 1, 64, 5),     # ragged S, windowed
        (1, 1, 2, 2, 16, 0),      # one token
        (2, 48, 4, 4, 96, 0),     # phi-3-vision's head_dim, global
        (1, 37, 4, 2, 96, 16),    # head_dim 96, GQA, ragged S, windowed
    ],
)
def test_gqa_head_dims_and_ragged_lengths(b, s, h, kv, hd, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, h, kv, hd, "float32", seed=s)
    scale = 1.0 / np.sqrt(hd)
    got = _f32(causal_attention(tq, tk, tv, scale=scale, window=window))
    np.testing.assert_allclose(got, _f32(_attention_ref(jq, jk, jv, scale, window)), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(
        got, _f32(ops.causal_attention(jq, jk, jv, scale=scale, window=window)), rtol=5e-4, atol=5e-4
    )


def test_first_token_attends_to_itself_only():
    _, (tq, tk, tv) = _inputs(1, 64, 2, 2, 16, "float32", seed=20)
    out = causal_attention(tq, tk, tv, scale=0.25, window=0)
    np.testing.assert_allclose(out[:, 0].numpy(), tv[:, 0].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "q,k,v,error",
    [
        (torch.ones(1, 4, 2, 16), torch.ones(1, 4, 3, 16), torch.ones(1, 4, 3, 16), ValueError),
        (torch.ones(4, 2, 16), torch.ones(4, 2, 16), torch.ones(4, 2, 16), ValueError),
        (torch.ones(1, 4, 2, 16), torch.ones(1, 5, 2, 16), torch.ones(1, 5, 2, 16), ValueError),
        (torch.ones(1, 4, 2, 16), torch.ones(1, 4, 2, 16).bfloat16(), torch.ones(1, 4, 2, 16), TypeError),
        (torch.ones(1, 4, 2, 16).double(),) * 3 + (TypeError,),
        (torch.ones(1, 4, 2, 16), torch.ones(1, 4, 2, 16, device="meta"), torch.ones(1, 4, 2, 16), ValueError),
    ],
    ids=["kv-heads", "rank", "lengths", "mixed-dtype", "float64", "devices"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(q, k, v, error):
    with pytest.raises(error):
        causal_attention(q, k, v, scale=0.25)


@pytest.mark.parametrize("head_dim", fa_mod.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_puts_bf16_at_64_96_128_256_on_the_tensor_cores(dtype, head_dim):
    want = "tensor-core" if dtype == torch.bfloat16 and head_dim in (64, 96, 128, 256) else "tf32-mma"
    assert fa_mod.route(dtype, head_dim) == want


def _c_switches():
    """The cases of ``flash_attention.cu``'s entry: {(is_bf16, hd): the
    launch it returns}, from its bfloat16 switch and its float32 one."""
    src = (fa_mod.build.CSRC_DIR / "flash_attention.cu").read_text()
    entry = src[src.index('extern "C" int flash_attention('):]
    entry = entry[: entry.index('extern "C" int flash_attention_smem(')]
    bf16_part = entry[entry.index("if (is_bf16) {"):]
    bf16_switch = bf16_part[: bf16_part.index("default:")]
    f32_switch = bf16_part[bf16_part.index("default:") + 1:]
    f32_switch = f32_switch[f32_switch.index("switch (hd)"):]
    f32_switch = f32_switch[: f32_switch.index("default:")]
    cases = {}
    for is_bf16, part in ((1, bf16_switch), (0, f32_switch)):
        for hd, call in re.findall(r"case (\d+): return (\w+::launch<[^>]*>)", part):
            cases[is_bf16, int(hd)] = call
    return cases


def test_head_dims_mirror_the_c_dispatch():
    """``HEAD_DIMS`` are the cases of both of ``flash_attention.cu``'s
    switches, the float32 one and the bfloat16 one, where 96 goes to the
    wgmma ``tc::launch``; the CUDA-core kernel and its dispatch are gone."""
    cases = _c_switches()
    src = (fa_mod.build.CSRC_DIR / "flash_attention.cu").read_text()
    for is_bf16 in (0, 1):
        assert tuple(hd for b, hd in cases if b == is_bf16) == fa_mod.HEAD_DIMS
    assert cases[1, 96] == "tc::launch<96>"
    assert "launch<__nv_bfloat16, 96>" not in src
    assert "int dispatch(" not in src and not re.search(r"(?<![:\w])launch<(T|float|__nv_bfloat16), \w+>\(", src)


def test_route_mirrors_the_c_dispatch():
    """For every (dtype, head_dim) the C entry launches the kernel that
    ``route`` names: ``tc::launch`` (wgmma) for "tensor-core", the
    split-TF32 ``mma::launch`` of that type and head_dim for "tf32-mma";
    float32 never goes to wgmma."""
    cases = _c_switches()
    for dtype, is_bf16, ctype in ((torch.float32, 0, "float"), (torch.bfloat16, 1, "__nv_bfloat16")):
        for hd in fa_mod.HEAD_DIMS:
            want = f"tc::launch<{hd}>" if fa_mod.route(dtype, hd) == "tensor-core" else f"mma::launch<{ctype}, {hd}>"
            assert cases[is_bf16, hd] == want, (dtype, hd)
    tc_dims = tuple(hd for (b, hd), call in cases.items() if call.startswith("tc::"))
    assert tc_dims == fa_mod.TENSOR_CORE_HEAD_DIMS


def _misaligned(shape, dtype):
    """A contiguous view whose data starts one element past an aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_alignment_check_rejects_a_misaligned_view_on_the_tensor_core_route(which):
    """Both routes copy 16-byte chunks with cp.async: a misaligned q, k or
    v is refused on the wgmma route and on the split-TF32 one."""
    for dtype, hd, want in ((torch.bfloat16, 64, "tensor-core"), (torch.bfloat16, 96, "tensor-core"),
                            (torch.float32, 64, "tf32-mma"), (torch.bfloat16, 32, "tf32-mma")):
        assert fa_mod.route(dtype, hd) == want
        tensors = {name: torch.zeros(1, 4, 2, hd, dtype=dtype) for name in "qkv"}
        tensors[which] = _misaligned((1, 4, 2, hd), dtype)
        assert tensors[which].is_contiguous() and tensors[which].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte-aligned"):
            fa_mod.check_alignment(*tensors.values())


def test_alignment_check_takes_aligned_tensors():
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 4, 2, 64, dtype=dtype)
        assert q.data_ptr() % 16 == 0
        fa_mod.check_alignment(q, q, q)


def test_library_path_is_under_the_checkout_build_dir():
    path = fa_mod.build.library_path("flash_attention")
    assert path.parent.parts[-2:] == ("build", "repro_torch")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shapes = [
        (2, 128, 4, 2, 32, 0), (2, 128, 4, 2, 32, 64), (2, 128, 4, 2, 32, 17),
        (1, 64, 4, 1, 256, 16), (1, 37, 4, 2, 32, 0), (2, 37, 2, 1, 64, 5),
        (1, 1, 2, 2, 16, 0), (1, 100, 2, 1, 128, 0), (2, 600, 4, 1, 256, 512),
    ]
    # The tensor-core route's head dims (bfloat16), global and windowed, at
    # one token, a ragged tile and a ragged length past several tiles.
    shapes += [
        (1, s, 4, kv, hd, window)
        for hd, kv in ((64, 4), (128, 2), (256, 1))
        for s in (1, 33, 2047)
        for window in (0, 512)
    ]
    for b, s, h, kv, hd, window in shapes:
        _, (tq, tk, tv) = _inputs(b, s, h, kv, hd, dtype, seed=s)
        tq, tk, tv = tq.cuda(), tk.cuda(), tv.cuda()
        before = tracing.counter("launches.causal_attention")
        got = causal_attention(tq, tk, tv, scale=hd**-0.5, window=window)
        torch.cuda.synchronize()
        assert tracing.counter("launches.causal_attention") == before + 1
        want = causal_attention_plain(tq, tk, tv, scale=hd**-0.5, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version_at_head_dim_96(dtype):
    """phi-3-vision's head_dim, bfloat16 on the wgmma route and float32 on
    the split-TF32 one: its path shape's heads, global and windowed,
    at one token, a ragged tile, a length past several tiles, GQA, and a
    ragged length under a window smaller than a tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert fa_mod.route(getattr(torch, dtype), 96) == ("tensor-core" if dtype == "bfloat16" else "tf32-mma")
    for b, s, h, kv, window in [
        (1, 1, 32, 32, 0), (2, 33, 4, 2, 0), (1, 700, 32, 32, 0), (2, 300, 8, 8, 64),
        (2, 256, 8, 2, 0), (1, 2047, 4, 1, 17),
    ]:
        _, (tq, tk, tv) = _inputs(b, s, h, kv, 96, dtype, seed=s)
        tq, tk, tv = tq.cuda(), tk.cuda(), tv.cuda()
        before = tracing.counter("launches.causal_attention")
        got = causal_attention(tq, tk, tv, scale=96**-0.5, window=window)
        torch.cuda.synchronize()
        assert tracing.counter("launches.causal_attention") == before + 1
        want = causal_attention_plain(tq, tk, tv, scale=96**-0.5, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# The tensor-core kernel's shared-memory tiles, modelled on the CPU: where
# load_tile writes each 16-byte chunk, and where wgmma's descriptors read it.
# ---------------------------------------------------------------------------
# The PTX ISA's wgmma matrix descriptor: start address, leading and stride
# byte offsets in 16-byte units at bits 0, 16 and 32, and the swizzle at bits
# 62-63 (1: 128 bytes, 2: 64 bytes, 3: 32 bytes).  A swizzle of W bytes XORs
# the address's 16-byte chunk bits (4 .. 3 + log2(W / 16)) with the bits from
# 7 up (CUTLASS's Swizzle<log2(W / 16), 4, 3>), and lays a K-major operand
# (and a transposed, MN-major one) out in rows of W bytes, 8 rows to an atom.
SWIZZLE_BYTES = {1: 128, 2: 64, 3: 32}
TC_HEAD_DIMS = (64, 96, 128, 256)
BQ = 64


def _cu_source():
    """``flash_attention.cu`` followed by ``wgmma.cuh``, where its tiles'
    panels, ``load_tile``, the descriptors and the wgmma instructions live
    (shared with the backward)."""
    csrc = fa_mod.build.CSRC_DIR
    return (csrc / "flash_attention.cu").read_text() + "\n" + (csrc / "wgmma.cuh").read_text()


def _flat(src):
    return " ".join(src.split())


def _panel(hd):
    """``Panel<hd>``, its constants parsed from ``wgmma.cuh`` (through
    ``_cu_source``)."""
    src = _cu_source()
    wide_div = re.search(r"WIDE = HD % (\d+) == 0;", src)
    cols = re.search(r"COLS = WIDE \? (\d+) : (\d+);", src)
    mode = re.search(r"MODE = WIDE \? (\d+) : (\d+);", src)
    swz = re.search(
        r"P::WIDE \? \(\(c % (\d+)\) \^ \(r % (\d+)\)\) : \(\(c % (\d+)\) \^ \(\(r >> (\d+)\) % (\d+)\)\)", src
    )
    assert wide_div and cols and mode and swz, "Panel's definition changed"
    for derived in ("ROW = 2 * COLS;", "CHUNKS = ROW / 16;", "ATOM = 8 * ROW;", "STEPS = ROW / 32;"):
        assert derived in src, derived
    wide = hd % int(wide_div.group(1)) == 0
    pick = 1 if wide else 2
    ncols = int(cols.group(pick))
    row = 2 * ncols
    m = [int(g) for g in swz.groups()]
    if wide:
        swizzle = lambda c, r: (c % m[0]) ^ (r % m[1])  # noqa: E731
    else:
        swizzle = lambda c, r: (c % m[2]) ^ ((r >> m[3]) % m[4])  # noqa: E731
    return {"cols": ncols, "row": row, "chunks": row // 16, "atom": 8 * row, "steps": row // 32,
            "mode": int(mode.group(pick)), "swizzle": swizzle}


def _kv_tile(hd):
    """``tc::kv_tile<hd>()``, its values parsed from ``flash_attention.cu``."""
    tile = re.search(r"return HD == (\d+) \? (\d+) : (\d+);", _cu_source())
    assert tile, "tc::kv_tile's definition changed"
    at, small, other = (int(g) for g in tile.groups())
    return small if hd == at else other


def _load_tile(hd, rows, base):
    """load_tile's address map: (row, 16-byte chunk of the row) -> the
    shared address it is copied to."""
    p = _panel(hd)
    assert "(c / P::CHUNKS) * (ROWS * P::ROW) + r * P::ROW + ((P::WIDE ? " in _flat(_cu_source())
    return {
        (r, c): base + (c // p["chunks"]) * (rows * p["row"]) + r * p["row"] + (p["swizzle"](c, r) << 4)
        for r in range(rows) for c in range(hd // 8)
    }


def _smem_desc(addr, lbo, sbo, mode):
    """``tc::smem_desc<mode>``."""
    src = _flat(_cu_source())
    for field in ("((addr >> 4) & 0x3FFF)", "((lbo >> 4) & 0x3FFF) << 16", "((sbo >> 4) & 0x3FFF) << 32",
                  "MODE << 62;"):
        assert field in src, field
    return ((addr >> 4) & 0x3FFF) | ((lbo >> 4) & 0x3FFF) << 16 | ((sbo >> 4) & 0x3FFF) << 32 | mode << 62


def _hw_read(desc, row, chunk):
    """The shared address wgmma reads for ``row`` (the 8-row-strided
    dimension: M or N of a K-major operand, K of an MN-major one) and the
    16-byte ``chunk`` of that row inside one swizzle atom, per the ISA."""
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    width = SWIZZLE_BYTES[desc >> 62]
    assert start % width + 16 * (chunk + 1) <= width, "a read leaves its swizzle row"
    addr = start + (row // 8) * sbo + (row % 8) * width + 16 * chunk
    return addr ^ (((addr >> 7) & (width // 16 - 1)) << 4)


@pytest.mark.parametrize("hd", TC_HEAD_DIMS)
def test_load_tile_map_is_a_bijection_onto_the_tile(hd):
    """Every 16-byte chunk of a q (64-row) or k / v (kv_tile-row) tile is
    written once, and the tile is filled, from an atom-aligned base."""
    for rows in (BQ, _kv_tile(hd)):
        base = 2 * 1024
        addrs = sorted(_load_tile(hd, rows, base).values())
        assert addrs == list(range(base, base + rows * hd * 2, 16))


@pytest.mark.parametrize("hd", TC_HEAD_DIMS)
def test_panel_takes_the_ptx_swizzle_of_its_row_width(hd):
    """A panel row is as wide as the descriptor's swizzle: 128 bytes when
    hd is a multiple of 64, else (hd 96) 64; its XOR is the ISA's."""
    p = _panel(hd)
    assert SWIZZLE_BYTES[p["mode"]] == p["row"] == (128 if hd % 64 == 0 else 64)
    assert hd % p["cols"] == 0
    for r in range(8):
        for c in range(p["chunks"]):
            addr = r * p["row"] + 16 * c
            assert addr ^ (((addr >> 7) & (p["row"] // 16 - 1)) << 4) == r * p["row"] + 16 * p["swizzle"](c, r)


@pytest.mark.parametrize("hd", TC_HEAD_DIMS)
def test_q_kt_descriptors_read_the_chunks_load_tile_wrote(hd):
    """S = q k^T: at k16 step kk the descriptor of q (and of k) reads, for
    each row, the two chunks of columns 16 kk .. 16 kk + 15 that load_tile
    put there."""
    p = _panel(hd)
    src = _flat(_cu_source())
    assert "const uint32_t step = (kk % P::STEPS) * 32;" in src
    assert "smem_desc<P::MODE>(q_s + (kk / P::STEPS) * (BQ * P::ROW) + step, 16, P::ATOM)" in src
    assert "smem_desc<P::MODE>(ks + (kk / P::STEPS) * (BK * P::ROW) + step, 16, P::ATOM)" in src
    base = 3 * 1024
    for rows in (BQ, _kv_tile(hd)):
        wrote = _load_tile(hd, rows, base)
        for kk in range(hd // 16):
            step = (kk % p["steps"]) * 32
            desc = _smem_desc(base + (kk // p["steps"]) * (rows * p["row"]) + step, 16, p["atom"], p["mode"])
            for r in range(rows):
                for half in range(2):
                    assert _hw_read(desc, r, half) == wrote[r, 2 * kk + half], (rows, kk, r, half)


@pytest.mark.parametrize("hd", TC_HEAD_DIMS)
def test_p_v_descriptors_read_the_chunks_load_tile_wrote(hd):
    """O += P v: at 16-key step kk, the MN-major descriptor of panel p of v
    reads, for each of the 16 keys (rows of 8-key groups, SBO apart), the
    panel's column chunks that load_tile put there; one wgmma's N, the
    panel's columns, spans exactly one swizzle row, so LBO is never used."""
    p = _panel(hd)
    src = _flat(_cu_source())
    assert "wgmma_rs<P::COLS>(acc[p], pa[kk], smem_desc<P::MODE>(vs + p * (BK * P::ROW) + kk * 16 * P::ROW, P::ATOM, P::ATOM));" in src
    assert 2 * p["cols"] == SWIZZLE_BYTES[p["mode"]]
    bk = _kv_tile(hd)
    base = 5 * 1024
    wrote = _load_tile(hd, bk, base)
    for kk in range(bk // 16):
        for panel in range(hd // p["cols"]):
            desc = _smem_desc(base + panel * (bk * p["row"]) + kk * 16 * p["row"], p["atom"], p["atom"], p["mode"])
            for key in range(16):
                for nc in range(p["chunks"]):
                    assert _hw_read(desc, key, nc) == wrote[16 * kk + key, panel * p["chunks"] + nc], (kk, panel, key, nc)


@pytest.mark.parametrize("hd", TC_HEAD_DIMS)
def test_tiles_start_on_swizzle_atoms(hd):
    """The swizzle reads the address's own bits, so q, and each stage's k
    and v, start on an atom of their panel width (``tc::Smem``, from a base
    rounded up to an atom), and the slack covers the rounding."""
    p = _panel(hd)
    src = _flat(_cu_source())
    assert "+ P::ATOM - 1) & ~uint32_t(P::ATOM - 1);" in src
    assert "static constexpr size_t BYTES = Q + 2 * STAGE + Panel<HD>::ATOM;" in src
    q_bytes, kv_bytes = BQ * hd * 2, _kv_tile(hd) * hd * 2
    for offset in (0, q_bytes, q_bytes + kv_bytes, q_bytes + 2 * kv_bytes, q_bytes + 3 * kv_bytes):
        assert offset % p["atom"] == 0
    assert q_bytes + 4 * kv_bytes + p["atom"] <= 227 * 1024
