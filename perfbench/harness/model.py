"""A configuration's model: the program's config object built from the
configuration file's ``model`` block, and the weights drawn from a seed.

The weights are the benchmark's inputs, handed alike to the program and to
the reference.  They come in the layout that the program's ``init_params``
returns, at the scales that the configuration's reference family gives
(``leaf_specs`` of ``reference/<family>.py``, which reads the
configuration's ``weights`` block), but drawn by the benchmark: every
random leaf is a view into one buffer of the served dtype, filled by one
call on the device's generator and scaled leaf by leaf in place.
"""
from __future__ import annotations

import math

import torch

from harness import spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ALIGN = 64  # elements between leaf starts in the weight buffer (128 bytes in bf16)

# Streams of one seed, so that weights, prompts and samples never share draws.
WEIGHTS, INPUTS, SAMPLE = 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for ``stream`` of the run's ``seed`` (any whole
    number); fits the 64 bits that ``manual_seed`` takes."""
    return (int(seed) * 1_000_003 + stream) % (1 << 62)


def arch_config(conf: dict):
    """The program's ``ArchConfig`` for a configuration file."""
    from repro_torch.configs.base import ArchConfig

    m = dict(conf["model"])
    m["full_attn_layers"] = tuple(m.get("full_attn_layers", ()))
    return ArchConfig(**m)


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if key == "layers":
            node = node.setdefault("layers", [])
        elif isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, {})
    node[path[-1]] = value


def make_weights(conf: dict, seed: int, device: "str | torch.device") -> dict:
    """The weights of ``conf`` drawn from ``seed`` on ``device``, in the
    configuration's served dtype (``conf["dtype"]``)."""
    m, served = conf["model"], DTYPES[conf["dtype"]]
    specs = spec.reference(conf["reference"]).leaf_specs(m, conf.get("weights"))
    normal = [s for s in specs if s[2] == "normal"]
    offsets, n = [], 0
    for _, shape, *_ in normal:
        offsets.append(n)
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    buf = torch.empty(n, dtype=served, device=device)
    buf.normal_(generator=gen)
    tree: dict = {}
    views = iter(zip(normal, offsets))
    for path, shape, init, scale, dt in specs:
        dtype = served if dt == "served" else DTYPES[dt]
        if init == "normal":
            _, off = next(views)
            t = buf[off: off + math.prod(shape)].view(shape)
            t.mul_(scale)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:
            t = torch.ones(shape, dtype=dtype, device=device)
        _put(tree, path, t)
    return tree


def leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a parameter tree, depth first in
    the dicts' order; paths as ``layers.3.attn.wq``."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            out.append((prefix[:-1], node))

    walk(tree, "")
    return out
