"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root of
the checkout, at first use, and loaded with ``ctypes``.  The library's file
name carries a hash of its source and of the headers beside it
(``csrc/*.cuh``), so an edited source or header is rebuilt and a built one
is reused.  Nothing here runs when the module is imported.

Every kernel has a fake form besides: on fake tensors (``FakeTensorMode``,
shapes and dtypes without storage) its wrapper allocates what it would
allocate on the card and calls, in place of the launch, the op that
``fake_launch`` defines.  That op does nothing, and carries the plain
version's FLOP formula for ``torch.utils.flop_counter``, so that a counted
fake run of a step (``roofline.counter``) sees the kernel's memory and
FLOPs and runs neither the kernel nor its plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# <checkout>/src/repro_torch/kernels/build.py -> <checkout>/build/repro_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built on a machine with the CUDA toolkit"
        )
    return str(path)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<library>.log``.  Raises with the
    compiler's output when ``nvcc`` fails.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib


def refuse_dtensors(kernel: str, *tensors) -> None:
    """Raise ``TypeError`` naming ``kernel`` if one of ``tensors`` is a
    DTensor on the card: the hand kernels take plain CUDA tensors, and a
    sharded operand must be made local (or replicated) by its caller, never
    handed to a plain version instead.  DTensors on the host go on to the
    plain versions, which are torch ops."""
    tensor_mod = sys.modules.get("torch.distributed.tensor")
    if tensor_mod is None:
        return
    for t in tensors:
        if isinstance(t, tensor_mod.DTensor) and t.device.type == "cuda":
            raise TypeError(
                f"the {kernel} kernel takes plain CUDA tensors; got a DTensor "
                f"{tuple(t.shape)} with placements {t.placements}"
            )


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (``FakeTensorMode``'s): shapes and
    dtypes on a device, no storage.  No tensor can be fake before the fake
    tensor module is imported, so the check costs no import."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return fake is not None and isinstance(t, fake.FakeTensor)


def refuse_fake_cuda(kernel: str, *tensors) -> None:
    """Raise ``TypeError`` if one of ``tensors`` is a fake CUDA tensor: a
    plain version stands for its kernel on the host only, and a fake run on
    the card takes the kernel's fake form."""
    for t in tensors:
        if is_fake(t) and t.device.type == "cuda":
            raise TypeError(f"{kernel}'s plain version reached by a fake CUDA tensor {tuple(t.shape)}")


def fake_launch(name: str, flops: Callable[..., int]) -> Callable[[list, list], None]:
    """The op ``repro_torch::<name>_launch(inputs, outputs)`` that stands
    for the launch of kernel ``name`` in its fake form: on fake tensors it
    does nothing and leaves ``outputs`` (allocated by the caller) as they
    are; ``flops(*input_shapes)`` is its count for
    ``torch.utils.flop_counter``.  A real tensor raises."""

    @torch.library.custom_op(f"repro_torch::{name}_launch", mutates_args=("outputs",))
    def launch(inputs: list[torch.Tensor], outputs: list[torch.Tensor]) -> None:
        raise TypeError(f"the fake form of {name} takes fake tensors only")

    @launch.register_fake
    def _(inputs, outputs):
        return None

    @register_flop_formula(getattr(torch.ops.repro_torch, f"{name}_launch"))
    def _(input_shapes, output_shapes, *, out_shape=None, **kwargs):
        return flops(*input_shapes)

    return launch
