"""ctypes binding of the host batch packer (``data/native/pack.cc``).

The port's copy of ``grounded_video_description_tpu/data/native_pack.py``.
``pack_segment`` is the padding and masking block of the ingest path
(misc/dataloader_anet.py:317-348).  At first use the C++ source is built
with the host compiler (``$CXX``, else ``g++``) into
``grounded_video_description_torch/_build/libgvd_pack-<hash>.so``
(gitignored, named by a hash of the source and flags), never into the
source tree.  Without a compiler, or if the build fails, the NumPy path
below runs: the JAX module's own rule for this host code, with the same
output (tests/test_torch_cli.py holds the two equal).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "pack.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lock = threading.Lock()


def build() -> Path:
    """Compile pack.cc into _build/ unless that library exists; returns
    its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    so = BUILD_DIR / f"libgvd_pack-{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:                     # the loader's threads call this at once
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"[native_pack] host packer unavailable ({e}); NumPy path")
            return None
        lib.pack_segment.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_double, ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pack_segment.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def pack_segment(proposals: np.ndarray, region_feat: np.ndarray,
                 gt_frms: np.ndarray, *, prop_thresh: float,
                 exclude_bgd: bool, max_proposal: int, max_box: int,
                 out: Optional[Tuple] = None, native: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """Returns (pad_proposals (P, 7) f32, pad_pnt_mask (P,) bool,
    pad_feat (P, C) f32, pad_frm_mask (P, max_box) bool).

    ``out``: optional C-contiguous destination arrays (pad_p f32, pad_m
    bool, pad_f f32, pad_fm bool), typically rows of the batch buffers;
    every element is overwritten.  ``native=False`` takes the NumPy
    path."""
    proposals = np.ascontiguousarray(proposals, np.float64)
    region_feat = np.ascontiguousarray(region_feat, np.float32)
    gt_frms = np.ascontiguousarray(gt_frms, np.float32)
    n_in, feat_dim = region_feat.shape
    assert proposals.shape == (n_in, 7)

    lib = _load() if native else None
    if lib is not None:
        if out is not None:
            pad_p, pad_m_b, pad_f, pad_fm_b = out
            assert pad_m_b.dtype == bool and pad_fm_b.dtype == bool
            for a in (pad_p, pad_m_b, pad_f, pad_fm_b):
                assert a.flags.c_contiguous
            # bool and uint8 share their itemsize; the C side writes 0/1
            pad_m = pad_m_b.view(np.uint8)
            pad_fm = pad_fm_b.view(np.uint8)
        else:
            pad_p = np.empty((max_proposal, 7), np.float32)
            pad_m = np.empty((max_proposal,), np.uint8)
            pad_f = np.empty((max_proposal, feat_dim), np.float32)
            pad_fm = np.empty((max_proposal, max_box), np.uint8)
        lib.pack_segment(
            proposals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(n_in),
            region_feat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(feat_dim),
            ctypes.c_double(prop_thresh),
            ctypes.c_int(int(exclude_bgd)),
            ctypes.c_int64(max_proposal),
            gt_frms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(len(gt_frms)),
            ctypes.c_int64(max_box),
            pad_p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            pad_m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pad_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            pad_fm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if out is not None:
            return pad_p, pad_m_b, pad_f, pad_fm_b
        return pad_p, pad_m.astype(bool), pad_f, pad_fm.astype(bool)

    # the NumPy path (the same output)
    n = min(n_in, max_proposal)
    if out is not None:
        pad_p, pad_m, pad_f, pad_fm = out
        pad_p[:] = 0.0
        pad_m[:] = True
        pad_f[:] = 0.0
        pad_fm[:] = True
    else:
        pad_p = np.zeros((max_proposal, 7), np.float32)
        pad_m = np.ones((max_proposal,), bool)
        pad_f = np.zeros((max_proposal, feat_dim), np.float32)
        pad_fm = np.ones((max_proposal, max_box), bool)

    mask = proposals[:n, 6] <= prop_thresh
    if exclude_bgd:
        mask |= proposals[:n, 5] == 0
    pad_m[:n] = mask
    pad_p[:n] = proposals[:n]
    pad_f[:n] = region_feat[:n]
    pad_fm[:n, :len(gt_frms)] = (
        proposals[:n, 4:5] != gt_frms.reshape(1, -1))
    pad_p[pad_m] = 0.0
    pad_f[pad_m] = 0.0
    return pad_p, pad_m, pad_f, pad_fm
