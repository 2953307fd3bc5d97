"""Plain reference of the decoder models (dense attention blocks and
Hymba's parallel attention and SSM heads), for one sequence, in float32
(or, for the control, with fp8 products: ``precision.matmul``).

It follows the model as the configuration file states it (its ``model``
block and ``departures``), from the equations, in plain PyTorch: no kernel,
no cache machinery, no batching.  It imports nothing of the program.  A
layer's weights are read as float32 when the layer runs, so a large model
needs float32 room for one layer at a time besides its served weights.

* ``prefill``: the last position's logits and every layer's decode state
  after the prompt (keys after RoPE and values, laid out as a full cache or
  a ring buffer; the SSM's state and last normed input), and the final
  hidden states, whose logits at any position ``head`` gives.
* ``loss``: the next-token cross-entropy of one sequence, each layer
  recomputed in the backward pass (``torch.utils.checkpoint``), for the
  train step's reference.

The SSM's recurrence ``h_t = a_t h_{t-1} + b_t`` is composed as a scan of
affine maps over the whole sequence (Hillis-Steele doubling, log2 S steps
of elementwise work), the same states as the step-by-step loop
(``sequential_scan``) at a fraction of its launches.

The family's side of the harness (the harness holds no knowledge of a model
family; a new family is a new file here with these functions):
``leaf_specs`` (the weights' layout and scales), ``matmul_weights`` and
``attention_calls`` (what ``harness.flops`` counts model FLOPs and the
attention kernel's work from),
``state_layout`` (the decode state after a prompt, and the number each part
of it is compared in) and ``tiny`` (the model at a CPU test's size).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from precision import matmul


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def window_of(m: dict, i: int) -> int:
    """Layer i's attention window, 0 for full causal attention."""
    if m.get("attn_kind", "full") == "full" or i in m.get("full_attn_layers", []):
        return 0
    return m["window"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x), scaled by 1 + w."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, heads, hd) at positions 0 .. S-1: the two
    halves of each head rotated by angle pos / theta^(2i / hd), the angles
    in float64."""
    s, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, mm) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: q (S, H, hd), k, v
    (S, KV, hd); query head h reads KV head h // (H / KV).  Softmax over
    the keys at or before each query (the last ``window`` of them when
    ``window`` > 0).  Returns (S, H * hd)."""
    s, h, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    pos = torch.arange(s, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window > 0:
        keep &= pos[:, None] - pos[None, :] < window
    outs = []
    for j in range(kv):
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)                 # (g, S, hd)
        scores = mm(qj, k[:, j].transpose(0, 1)[None]) / math.sqrt(hd)
        p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(mm(p, v[:, j][None]))                            # (g, S, hd)
    return torch.cat(outs, dim=0).transpose(0, 1).reshape(s, h * hd)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every state h_t (S, d, N) of ``h_t = a_t h_{t-1} + b_t`` from h = 0,
    with a (S, d) and b (S, d, N): an inclusive scan of the maps
    ``h -> a h + b`` (composition ``(a2, b2) o (a1, b1) = (a2 a1, a2 b1 +
    b2)``) by doubling."""
    s, step = a.shape[0], 1
    while step < s:
        b = torch.cat([b[:step], a[step:, :, None] * b[:-step] + b[step:]])
        a = torch.cat([a[:step], a[step:] * a[:-step]])
        step *= 2
    return b


def sequential_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``linear_scan`` token by token: its definition."""
    h = torch.zeros_like(b[0])
    out = []
    for t in range(a.shape[0]):
        h = a[t][:, None] * h + b[t]
        out.append(h)
    return torch.stack(out)


def ssm(x: torch.Tensor, p: dict, mm) -> tuple[torch.Tensor, torch.Tensor]:
    """Hymba's SSM heads on the normed input x (S, D): the selective state
    space recurrence per channel d and state n,

        h_t = exp(-softplus(dt_t) A) h_{t-1} + softplus(dt_t) u_t B_t^T
        y_t = C_t . h_t + D u_t,

    u = x W_in, B = x W_B, C = x W_C, dt = x W_dt, A = exp(A_log), gated by
    silu(x W_gate) and projected by W_out.  Returns (output (S, D), the
    state after the last token (d, N))."""
    u = mm(x, p["w_in"])
    z = F.silu(mm(x, p["w_gate"]))
    b_t, c_t = mm(x, p["w_B"]), mm(x, p["w_C"])
    dt = F.softplus(mm(x, p["w_dt"]))
    a = torch.exp(-dt * torch.exp(p["A_log"].float()))
    states = linear_scan(a, (dt * u)[:, :, None] * b_t[:, None, :])
    y = torch.einsum("sdn,sn->sd", states, c_t) + p["D"].float() * u
    return mm(y * z, p["w_out"]), states[-1]


def mlp(x: torch.Tensor, p: dict, kind: str, mm) -> torch.Tensor:
    if kind == "swiglu":
        return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_in"]), p["w_out"])
    if kind == "relu2":
        return mm(F.relu(mm(x, p["w_in"])).square(), p["w_out"])
    if kind == "gelu":
        return mm(F.gelu(mm(x, p["w_in"]), approximate="tanh"), p["w_out"])
    raise ValueError(kind)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def layer(m: dict, i: int, p: dict, h: torch.Tensor, mm) -> tuple[torch.Tensor, dict]:
    """Layer i on h (S, D): pre-norm attention (averaged with the SSM heads
    on the same normed input in a Hymba layer), then the pre-norm MLP, each
    added to the residual.  Returns (h, the layer's decode state)."""
    eps, hd = m["norm_eps"], _hd(m)
    x = rms_norm(h, p["ln1"], eps)
    a = p["attn"]
    q, k, v = mm(x, a["wq"]), mm(x, a["wk"]), mm(x, a["wv"])
    if "bq" in a:
        q, k, v = q + a["bq"].float(), k + a["bk"].float(), v + a["bv"].float()
    s = x.shape[0]
    q = rope(q.view(s, m["n_heads"], hd), m["rope_theta"])
    k = rope(k.view(s, m["n_kv_heads"], hd), m["rope_theta"])
    v = v.view(s, m["n_kv_heads"], hd)
    y = mm(attention(q, k, v, window_of(m, i), mm), a["wo"])
    state = {"k": k, "v": v}
    if m.get("block") == "hymba":
        y_ssm, state["ssm"] = ssm(x, p["ssm"], mm)
        state["ssm_prev"] = x[-1]
        y = 0.5 * (y + y_ssm)
    h = h + y
    return h + mlp(rms_norm(h, p["ln2"], eps), p["mlp"], m["mlp"], mm), state


def cache_slots(m: dict, i: int, kv: torch.Tensor, max_len: int) -> torch.Tensor:
    """Layer i's keys or values of a prompt (S, KV, hd) as decode reads
    them: position t in slot t of a full cache of ``max_len`` slots (empty
    slots zero), or, in a window layer, in slot t % W of a ring buffer of W
    slots that holds the last W positions."""
    w, s = window_of(m, i), kv.shape[0]
    size = min(w, max_len) if w else max_len
    out = kv.new_zeros((size, *kv.shape[1:]))
    first = max(0, s - size)
    out[torch.arange(first, s, device=kv.device) % size] = kv[first:]
    return out


def head(m: dict, params: dict, h: torch.Tensor, arith: str = "float32") -> torch.Tensor:
    """Logits (rows, V) of final hidden states h (rows, D)."""
    return matmul(arith)(rms_norm(h, params["final_norm"], m["norm_eps"]), params["lm_head"])


@torch.no_grad()
def prefill(m: dict, params: dict, tokens: torch.Tensor, max_len: int, arith: str = "float32"):
    """The prompt ``tokens`` (S,) through every layer: returns (the last
    position's logits (V,), [each layer's state: ``k``, ``v`` in cache
    slots, and ``ssm``, ``ssm_prev`` in a Hymba layer], the final hidden
    states (S, D))."""
    mm = matmul(arith)
    h = params["embed"][tokens].float()
    states = []
    for i, p in enumerate(params["layers"]):
        h, st = layer(m, i, _f32(p), h, mm)
        st["k"], st["v"] = cache_slots(m, i, st["k"], max_len), cache_slots(m, i, st["v"], max_len)
        states.append(st)
    return head(m, params, h[-1:], arith)[0], states, h


def loss(m: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor, arith: str = "float32",
         positions: slice | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence under float32
    ``params`` (leaves that may require grad), each layer recomputed in the
    backward pass.  ``positions`` narrows the mean (a planted fault)."""
    mm = matmul(arith)
    h = params["embed"][tokens]

    def run(i, h, p):
        return layer(m, i, p, h, mm)[0]

    for i, p in enumerate(params["layers"]):
        h = checkpoint(run, i, h, p, use_reentrant=False)
    logits = mm(rms_norm(h, params["final_norm"], m["norm_eps"]), params["lm_head"])
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[:, None])[:, 0]
    return nll[positions].mean() if positions is not None else nll.mean()


# ---------------------------------------------------------------------------
# The family's side of the harness
# ---------------------------------------------------------------------------
RESIDUAL_OUT_SCALES = {None: lambda n_layers: 1.0, "1/sqrt(2 n_layers)": lambda n_layers: 1 / math.sqrt(2 * n_layers)}


def leaf_specs(m: dict, weights: dict | None = None) -> list[tuple[tuple, tuple, str, float, str]]:
    """(path, shape, init, scale, dtype) of every parameter, in the order of
    the program's ``init_params`` dicts, at its scales; ``init`` is
    ``normal`` (times ``scale``), ``zeros`` or ``ones``; a path is a tuple of
    keys (an int for a layer); ``dtype`` is ``served`` or a dtype's name.
    ``weights`` is the configuration's ``weights`` block: ``embed_std``, and
    ``residual_out_scale``, an extra scale of the residual branches' output
    matrices."""
    weights = weights or {}
    d, v, hd = m["d_model"], m["vocab_size"], _hd(m)
    h, kv = m["n_heads"], m["n_kv_heads"]
    s_in = 1 / math.sqrt(d)
    res = RESIDUAL_OUT_SCALES[weights.get("residual_out_scale")](m["n_layers"])
    out = [
        (("embed",), (v, d), "normal", weights.get("embed_std", s_in), "served"),
        (("final_norm",), (d,), "zeros", 0.0, "served"),
        (("lm_head",), (d, v), "normal", s_in, "served"),
    ]
    for i in range(m["n_layers"]):
        p = ("layers", i)
        out += [(p + ("ln1",), (d,), "zeros", 0.0, "served"), (p + ("ln2",), (d,), "zeros", 0.0, "served")]
        a = p + ("attn",)
        out += [
            (a + ("wq",), (d, h * hd), "normal", s_in, "served"),
            (a + ("wk",), (d, kv * hd), "normal", s_in, "served"),
            (a + ("wv",), (d, kv * hd), "normal", s_in, "served"),
            (a + ("wo",), (h * hd, d), "normal", res / math.sqrt(h * hd), "served"),
        ]
        if m.get("qkv_bias"):
            out += [(a + ("bq",), (h * hd,), "zeros", 0.0, "served"),
                    (a + ("bk",), (kv * hd,), "zeros", 0.0, "served"),
                    (a + ("bv",), (kv * hd,), "zeros", 0.0, "served")]
        if m.get("block") == "hymba":
            di, st, s = m["ssm_inner"], m["ssm_state"], p + ("ssm",)
            out += [
                (s + ("w_in",), (d, di), "normal", s_in, "served"),
                (s + ("w_gate",), (d, di), "normal", s_in, "served"),
                (s + ("w_B",), (d, st), "normal", s_in, "served"),
                (s + ("w_C",), (d, st), "normal", s_in, "served"),
                (s + ("w_dt",), (d, di), "normal", s_in, "served"),
                (s + ("A_log",), (di,), "zeros", 0.0, "float32"),
                (s + ("D",), (di,), "ones", 0.0, "float32"),
                (s + ("w_out",), (di, d), "normal", res / math.sqrt(di), "served"),
            ]
        f, ff = p + ("mlp",), m["d_ff"]
        out += [(f + ("w_in",), (d, ff), "normal", s_in, "served"),
                (f + ("w_out",), (ff, d), "normal", res / math.sqrt(ff), "served")]
        if m["mlp"] == "swiglu":
            out.append((f + ("w_gate",), (d, ff), "normal", s_in, "served"))
    return out


def layer_matmul_weights(m: dict) -> int:
    """Weights that multiply in one layer (projections, MLP, SSM)."""
    d, hd = m["d_model"], _hd(m)
    n = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    n += {"swiglu": 3, "gelu": 2, "relu2": 2}[m["mlp"]] * d * m["d_ff"]
    if m.get("block") == "hymba":
        di, st = m["ssm_inner"], m["ssm_state"]
        n += 3 * d * di + 2 * d * st + di * d       # w_in, w_gate, w_dt; w_B, w_C; w_out
    return n


def matmul_weights(m: dict) -> tuple[int, int]:
    """(weights that multiply every token, weights of the output head that
    multiply each position it runs on), for ``harness.flops``."""
    return m["n_layers"] * layer_matmul_weights(m), m["d_model"] * m["vocab_size"]


def attention_calls(m: dict) -> list[tuple[int, int, int, int]]:
    """(query heads, KV heads, head_dim, window) of each layer's attention
    call in a forward pass, window 0 for full causal attention."""
    return [(m["n_heads"], m["n_kv_heads"], _hd(m), window_of(m, i)) for i in range(m["n_layers"])]


def state_layout(m: dict, i: int) -> dict[str, tuple[str, bool]]:
    """Layer i's decode state after a prompt, as ``prefill`` returns it and
    the program's caches hold it: each key with the compared number it
    counts in, and whether it is a full cache (``max_len`` slots, the prompt
    in the first S, the rest empty) rather than compared whole."""
    w = window_of(m, i)
    kv = ("kv_window", False) if w else ("kv_global", True)
    out = {"k": kv, "v": kv}
    if m.get("block") == "hymba":
        out.update(ssm=("ssm_state", False), ssm_prev=("ssm_prev", False))
    return out


def tiny(m: dict) -> dict:
    """The model block ``m`` at a size a CPU runs in a second: 2 layers (a
    Hymba model's first full, its second windowed), width 64."""
    m = dict(m, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
    if m.get("block") == "hymba":
        m.update(window=16, full_attn_layers=[0], ssm_inner=128)
    return m
