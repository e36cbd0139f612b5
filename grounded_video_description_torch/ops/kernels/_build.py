"""Build and bind the port's CUDA kernels.

At first use, every ``csrc/*.cu`` of the package is compiled with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, and loaded with ``ctypes``.  The library lives in
``grounded_video_description_torch/_build/`` (listed in .gitignore),
named by a hash of the sources, so a changed source builds anew and an
unchanged one is loaded as it is.  Processes that ask for it at once (the
ranks of a data-parallel run) build it once: the first holds a lock on
the build directory while it builds, the others wait and load its
library.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.  Pointers and the stream travel as ``c_void_p``.

``launches`` counts, per kernel, the launches its wrapper made; a run
sets it to zero with ``reset_launches`` and reads it afterwards to show
that the path it drove went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches: collections.Counter = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry point in csrc/
_SIGNATURES = {
    # dtype, p_pool, att_h, pool, alpha_w, alpha_b, att_mask, pnt_mask,
    # att_res, grd, B, R, H, D, the masks' row strides, then the plan
    # (splits, ROIs per split, warps per block, warps per group, ROIs per
    # slot, copy route, column groups, smem), stream
    "gvd_region_attention": [_I] + [_P] * 9 + [_I] * 14 + [_P],
    # dtype, copy route, ROIs per slot, column groups, warps per block,
    # splits, smem
    "gvd_region_attention_max_clusters": [_I] * 7,
    # dtype, mode, gi, wh, bh, out, T, B, H, then the plan (route, C,
    # tile, Up, KW, KR, rows per thread or m16 tiles, smem), exchange_only,
    # stream
    "gvd_birnn_recurrence": [_I, _I] + [_P] * 4 + [_I] * 12 + [_P],
    # dtype, mode, H, the plan
    "gvd_birnn_max_clusters": [_I] * 11,
    # dtype, A, W, bias, C, M, N, K, relu, stream
    "gvd_gemm": [_I] + [_P] * 4 + [_I] * 4 + [_P],
    # dtype, qkv, out, scratch, B, R, D, n_heads, inv_scale, stream
    "gvd_attention": [_I, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # dtype, x, y, gamma, beta, out, rows, D, eps, stream
    "gvd_residual_layer_norm": [_I] + [_P] * 5 + [_I, _I, _F, _P],
    # dtype, q, k, v, out, lse, seed, scratch, B, R, D, n_heads, inv_scale,
    # rate, salt_base, salt_mul, stream
    "gvd_attention_train_fwd": [_I] + [_P] * 7 + [_I] * 4 + [_F, _F, _I, _I,
                                                             _P],
    # dtype, q, k, v, out, dout, lse, seed, dq, dk, dv, delta, scratch, B,
    # R, D, n_heads, inv_scale, rate, salt_base, salt_mul, stream
    "gvd_attention_train_bwd": [_I] + [_P] * 12 + [_I] * 4 + [_F, _F, _I, _I,
                                                              _P],
    # dtype, q, k, v, out, scratch, N, R, d, stream
    "gvd_flash_self_attention": [_I] + [_P] * 5 + [_I] * 3 + [_P],
    # dtype, n, src0, src1, src2, src3, dst, B, R, D, n_heads, ld, stream
    "gvd_pack_heads": [_I, _I] + [_P] * 5 + [_I] * 5 + [_P],
    # the bf16 attention's tile rows; the packed width of a head (hs)
    "gvd_attention_tile": [],
    "gvd_packed_width": [_I],
    # dtype, layout, A, lda, B, ldb, M, N, K, splits, k_split, bias, relu,
    # mask, resid, C, c_f32, c2, partial, stream
    "gvd_k5_gemm": [_I, _I, _P, _I, _P] + [_I] * 6 + [_P, _I, _P, _P, _P,
                                                      _I, _P, _P, _P],
    # dtype, x_f32, x, a, seed, salt_base, R, rate, keep, gamma, beta,
    # out_f32, out_t, normed, sigma, rows, D, eps, stream
    "gvd_k5_ln_fwd": [_I, _I] + [_P] * 3 + [_I, _I, _F, _F] + [_P] * 6
                     + [_I, _I, _F, _P],
    # dtype, g_f32, g, normed, sigma, gamma, seed, salt_base, R, rate, keep,
    # dy, dyd, dyd_t, rows, D, eps, stream
    "gvd_k5_ln_bwd": [_I, _I] + [_P] * 5 + [_I, _I, _F, _F, _P, _P, _P, _I,
                                             _I, _F, _P],
    # dtype, a_f32, a, b, M, N, chunks, partial, out1, out2, stream
    "gvd_k5_colsum": [_I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # dtype, 4 banks and the pnt mask, 13 weights, 10 state buffers,
    # 3 outputs, the stamps (see csrc/decode_scan.cu), B, T, R, H, A, E, V,
    # Vp, L, unk, the plan (grid, 4 splits, smem), barriers_only, stream
    "gvd_greedy_decode": [_I] + [_P] * 32 + [_I] * 17 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into _build/libgvd_kernels-<hash>.so unless
    that file exists already; returns its path.  One nvcc per source,
    all started together, then one link, under the build directory's
    lock (``.lock``)."""
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"libgvd_kernels-{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.is_file():        # else built while this one waited
            _compile(sources, so, h.hexdigest()[:16])
    return so


def _compile(sources, so: Path, digest: str) -> None:
    """The nvcc runs of ``build``; no object or partial library outlives
    them."""
    tag = f"{digest}.{os.getpid()}"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [BUILD_DIR / f"{s.stem}-{tag}.o" for s in sources
            if s.suffix == ".cu"]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        jobs = []
        for s, obj in zip((s for s in sources if s.suffix == ".cu"), objs):
            cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(s)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        for path in objs + [tmp]:
            path.unlink(missing_ok=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {code}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for a C entry point; None for no tensor
    (a null pointer)."""
    return t.data_ptr() if t is not None else None


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, not {t.dtype}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start, for kernels that load 16
    bytes at a time; copies only a view that is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need a backward that the kernel ``name``
    does not have: its outputs are written through raw pointers, so they
    would carry no ``grad_fn`` and training would silently stop the
    gradient there.  Wrappers call it before choosing a device."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is an inference kernel with no backward, and an input "
            "requires grad: call it under torch.no_grad(), or take the "
            "differentiable path (the model's train=True)")
